"""Localizer tracked step, pose-only solve: the median of the program's
``loc.solve`` spans (``solve_pose_only``: 30 damped Huber steps on the
matched points) opened inside a ``loc.step`` span (the per-frame tracked
step) in the traced part of the window, in ms.

The spans are host intervals on the profiler's clock (``time.time_ns``),
recorded by ``se2lam_tpu_torch.utils.timing.RECORDER`` while the profiler
runs. The solve reads nothing back, so its interval is the host's time to
queue it: device work queued faster than it runs finishes in the step's
read, outside this span (a solve captured in a CUDA graph would read near
0 here). It also holds the profiler's own host cost of each launch (~13 us
a launch, measured on an H100 host: ~105 ms of a solve's 8,064 launches),
so a change that removes launches reads a larger gain here than end to
end. A program without the recorder reads None."""
import statistics

from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    steps = {r.id for r in rec.records("loc.step", run.trace.t0, run.trace.t1)}
    ms = [r.ms for r in rec.records("loc.solve", run.trace.t0, run.trace.t1)
          if r.parent in steps]
    return statistics.median(ms) if ms else None
