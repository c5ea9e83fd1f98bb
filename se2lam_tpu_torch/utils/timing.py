"""Per-stage timing (port of se2lam_tpu.utils.timing).

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
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["WorkTimer", "StageTimer", "device_trace", "measure_rtt"]


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


class StageTimer:
    """Named-stage aggregator with mean/p50/max/count; with ``block`` each
    ``timed`` call waits for its output's devices."""

    def __init__(self, block: bool = False):
        self.block = block
        self.samples: dict[str, list[float]] = defaultdict(list)

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

    def report(self) -> str:
        lines = [f"{'stage':16s} {'n':>5s} {'mean ms':>9s} {'p50':>8s} "
                 f"{'max':>8s} {'total s':>8s}"]
        for name, xs in sorted(self.samples.items()):
            a = np.asarray(xs)
            lines.append(f"{name:16s} {len(a):5d} {a.mean():9.2f} "
                         f"{np.median(a):8.2f} {a.max():8.2f} {a.sum() / 1000:8.2f}")
        return "\n".join(lines)

    def reset(self):
        self.samples.clear()


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
