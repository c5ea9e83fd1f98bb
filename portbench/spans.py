"""Spans and holds around the program's functions, installed from outside
by replacing a module or class attribute for the length of a run (as
``chip_smoke.py``'s ``StageTimer`` and ``Counted`` do).

A span records, for every call, CUDA events on the current stream before
and after it and the host's clock at entry and exit; the events are read
once the window has closed, so a span adds no synchronisation. A hold
keeps the arguments and the result of calls (references, no copy) for
readers to count their work after the window.

A target is ``"package.module:attr"`` or ``"package.module:Class.method"``.
"""
from __future__ import annotations

import functools
import importlib
import time

import torch

__all__ = ["Span", "Hold", "resolve"]


def resolve(target: str):
    """(owner, attribute name) of a target."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *outer, name = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, name


class _Patch:
    def __init__(self, target: str):
        self.target = target
        self.owner, self.name = resolve(target)
        self.orig = None

    def install(self):
        # what is there now: another patch of the same target nests
        self.orig = self.owner.__dict__[self.name]
        # the wrapper carries the function's attributes, such as a kernel
        # wrapper's ``launches`` counter, which the program updates through
        # the name it calls; remove() hands them back
        self.wrapper = functools.wraps(self.orig)(self._wrap(self.orig))
        setattr(self.owner, self.name, self.wrapper)
        return self

    def remove(self):
        for k, v in vars(self.wrapper).items():
            if k != "__wrapped__" and hasattr(self.orig, "__dict__"):
                setattr(self.orig, k, v)
        setattr(self.owner, self.name, self.orig)


class Span(_Patch):
    """Device and host intervals of every call of ``target``."""

    def __init__(self, name: str, target: str, device_events: bool = True):
        super().__init__(target)
        self.label = name
        self.device_events = device_events
        self.events = []      # (start event, end event)
        self.host = []        # (start ns, end ns) of time.time_ns

    def _wrap(self, fn):
        span = self

        def spanned(*args, **kw):
            h0 = time.time_ns()
            if span.device_events:
                a = torch.cuda.Event(enable_timing=True)
                a.record()
            try:
                return fn(*args, **kw)
            finally:
                if span.device_events:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record()
                    span.events.append((a, b))
                span.host.append((h0, time.time_ns()))

        return spanned

    def ms(self) -> list[float]:
        """Each call's device interval in ms (synchronises once)."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class Hold(_Patch):
    """The (args, kwargs, result) of the calls of ``target`` whose index is
    in ``keep``, or for which ``keep(index, args)`` is true (all calls when
    ``keep`` is None). ``tags`` holds, for each kept call, what ``tag``
    was when it was made (the harness sets it to the window's frame)."""

    def __init__(self, target: str, keep=None):
        super().__init__(target)
        self.keep = keep
        self.calls = 0
        self.tag = None
        self.kept = []        # (call index, args, kwargs, result)
        self.tags = []

    def _wrap(self, fn):
        hold = self

        def held(*args, **kw):
            out = fn(*args, **kw)
            keep = hold.keep
            if keep is None or (keep(hold.calls, args) if callable(keep) else hold.calls in keep):
                hold.kept.append((hold.calls, args, kw, out))
                hold.tags.append(hold.tag)
            hold.calls += 1
            return out

        return held
