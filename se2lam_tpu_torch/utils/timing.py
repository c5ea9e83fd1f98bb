"""Per-stage timing and the program's span recorder (port of
se2lam_tpu.utils.timing, extended).

The reference's ``WorkTimer`` millisecond stopwatch
(include/se2lam/Config.h:42-58) and its t1..t5 stage prints
(src/GlobalMapper.cpp:91-163), with what the reference lacks: statistics
per stage, a ``torch.profiler`` trace context and the host-to-device round
trip floor.

PyTorch returns from a CUDA call before the device finishes it, so a
stopwatch around device work measures the enqueue. ``StageTimer(block=
True)`` synchronises the devices of a timed call's output tensors before
it stops the clock, which costs the overlap of host and device: turn it on
only to diagnose.

The spans. The program's stages open ``span(name)`` blocks (the names are
listed in ``system.py``'s docstring); the process-wide ``StageTimer``
``RECORDER`` keeps a record of each: its name, its start and end on
``time.time_ns`` (the clock of ``torch.profiler``'s kineto events, so a
span joins the device trace), the id of the span it opened inside, a
request id (taken by a span opened with no span open, such as a frame's
``slam.frame`` or ``loc.frame``, and inherited by everything inside it),
and small integer counts from values the program already holds on the
host. Records go to a ring of ``capacity`` entries; the oldest are
dropped first and ``dropped`` counts them. A span adds no device read and
no synchronisation, so a stage's interval is on the host's clock: it ends
with its device work where the stage ends in a read, and otherwise when
its last launch is queued.

Recording is on only while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``) or inside a
``tracing()`` block; off, a span costs a flag read and returns one shared
no-op context. ``RECORDER.records(name, t0, t1)`` selects records by name
and start time, and ``RECORDER.report()`` tabulates them by stage, with
the sum of each count.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from ..device import resolve_device

__all__ = ["WorkTimer", "StageTimer", "SpanRecord", "RECORDER", "span", "tracing",
           "device_trace", "measure_rtt"]


class WorkTimer:
    """Stopwatch: start() … stop() → milliseconds."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    @property
    def ms(self) -> float:
        return self.stop()


def _cuda_devices(out, found: set):
    """The CUDA devices of the tensors in a nest of tuples, lists and dicts."""
    if torch.is_tensor(out):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _cuda_devices(v, found)
    return found


class SpanRecord:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns``;
    ``end_ns`` is 0 while it is open), the ``id`` of the span it opened
    inside (``parent``, -1 for none), its ``request`` and its ``counts``
    (None, or name → int). Entered, it is the innermost open span of its
    thread; ``count`` attaches a count before it closes."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request", "counts", "_stack")

    def __init__(self, id_, name, parent, request, stack):
        self.id, self.name, self.parent, self.request = id_, name, parent, request
        self.counts = None
        self._stack = stack
        self.end_ns = 0
        self.start_ns = time.time_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._stack.pop()
        return False

    def count(self, key: str, value):
        if self.counts is None:
            self.counts = {}
        self.counts[key] = int(value)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _NoRecord:
    """The span of a recorder that is off: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key, value):
        pass


class StageTimer:
    """Named-stage aggregator with mean/p50/max/count; with ``block`` each
    ``timed`` call waits for its output's devices. It also keeps the span
    records of ``open`` in a ring of ``capacity`` (the process-wide
    ``RECORDER`` is the one the program's ``span`` blocks feed), and
    ``report`` tabulates both."""

    def __init__(self, block: bool = False, capacity: int = 65536):
        self.block = block
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.ring: deque[SpanRecord] = deque(maxlen=capacity)
        self.dropped = 0
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._local = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.samples[name].append((time.perf_counter() - t0) * 1000.0)

    def timed(self, name: str, fn, *args, **kw):
        """Run fn and record its duration; with ``block``, the duration ends
        when the devices of the result's CUDA tensors have finished."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.block:
            for dev in _cuda_devices(out, set()):
                torch.cuda.synchronize(dev)
        self.samples[name].append((time.perf_counter() - t0) * 1000.0)
        return out

    def open(self, name: str):
        """A new span record inside the innermost open span of this thread
        (its request's first when none is open), kept in the ring."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        if st:
            parent, request = st[-1].id, st[-1].request
        else:
            parent, request = -1, next(self._requests)
        rec = SpanRecord(next(self._ids), name, parent, request, st)
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        self.ring.append(rec)
        st.append(rec)
        return rec

    def records(self, name=None, t0: int | None = None, t1: int | None = None):
        """The closed records whose name is ``name`` (a string, or a
        collection of names; any for None) and whose start lies in
        [``t0``, ``t1``] (``time.time_ns``; open-ended for None)."""
        names = {name} if isinstance(name, str) else name
        return [r for r in list(self.ring)
                if r.end_ns and (names is None or r.name in names)
                and (t0 is None or r.start_ns >= t0) and (t1 is None or r.start_ns <= t1)]

    def report(self) -> str:
        """A line a stage: the ``stage``/``timed`` samples, then the closed
        spans by name; ``self s`` is a span's time outside its children,
        and ``counts`` each count's sum over the span's records."""
        rows = {name: (xs, sum(xs) / 1000, {}) for name, xs in self.samples.items()}
        recs = self.records()
        child = defaultdict(int)
        for r in recs:
            child[r.parent] += r.end_ns - r.start_ns
        by = defaultdict(lambda: ([], [0], defaultdict(int)))
        for r in recs:
            xs, own, counts = by[r.name]
            xs.append(r.ms)
            own[0] += r.end_ns - r.start_ns - child[r.id]
            for key, v in (r.counts or {}).items():
                counts[key] += v
        rows.update((name, (xs, own[0] / 1e9, counts)) for name, (xs, own, counts) in by.items())
        lines = [f"{'stage':16s} {'n':>5s} {'mean ms':>9s} {'p50':>8s} "
                 f"{'max':>8s} {'total s':>8s} {'self s':>8s}  counts"]
        for name, (xs, own, counts) in sorted(rows.items()):
            a = np.asarray(xs)
            lines.append(f"{name:16s} {len(a):5d} {a.mean():9.2f} "
                         f"{np.median(a):8.2f} {a.max():8.2f} {a.sum() / 1000:8.2f} {own:8.2f}  "
                         + " ".join(f"{k}={v}" for k, v in counts.items()))
        return "\n".join(line.rstrip() for line in lines)

    def reset(self):
        self.samples.clear()
        self.ring.clear()
        self.dropped = 0


# the process-wide recorder of the program's spans
RECORDER = StageTimer()
_OFF = _NoRecord()
_tracing = 0          # open tracing() blocks


def span(name: str):
    """A span of the program's stage ``name`` (``with span(...) as s:``),
    recorded by ``RECORDER`` while a profiler session records or a
    ``tracing()`` block is open; otherwise the shared no-op span."""
    if not (_tracing or _profiler._is_profiler_enabled):
        return _OFF
    return RECORDER.open(name)


@contextlib.contextmanager
def tracing():
    """Record the program's spans inside the block, with no profiler
    (``RECORDER.report()`` then gives the per-stage table)."""
    global _tracing
    _tracing += 1
    try:
        yield RECORDER
    finally:
        _tracing -= 1


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the block (the host, and the card when
    there is one), written as ``<logdir>/trace.json`` for chrome://tracing
    or Perfetto. Yields the profiler (``key_averages()`` for sums by op)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def measure_rtt(device=None, reps: int = 5) -> float:
    """Median host→device→host round trip, in seconds: one tiny kernel on
    ``device`` (None means the card) and a read of its scalar, after one
    warm-up round. The floor under any timed region that ends in a read."""
    dev = resolve_device(device)
    x = torch.ones((), dtype=torch.float32, device=dev)
    float(x * 2.0)
    rtts = []
    for r in range(reps):
        t0 = time.perf_counter()
        float(x * float(r))
        rtts.append(time.perf_counter() - t0)
    return float(np.median(rtts))
