"""Localizer tracked step, projection and K2 match: the median of the
program's ``loc.match`` spans (``localizer._project_and_match``: the map's
points projected and matched through K2) opened inside a ``loc.step``
span (the per-frame tracked step) in the traced part of the window, in ms.

The spans are host intervals on the profiler's clock (``time.time_ns``),
recorded by ``se2lam_tpu_torch.utils.timing.RECORDER`` while the profiler
runs. The match reads nothing back, so its interval is the host's time to
queue it: device work queued faster than it runs finishes in the step's
read, outside this span. It also holds the profiler's own host cost of
each launch (~13 us a launch, measured on an H100 host; ~89 launches a
match). A program without the recorder reads None."""
import statistics

from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    steps = {r.id for r in rec.records("loc.step", run.trace.t0, run.trace.t1)}
    ms = [r.ms for r in rec.records("loc.match", run.trace.t0, run.trace.t1)
          if r.parent in steps]
    return statistics.median(ms) if ms else None
