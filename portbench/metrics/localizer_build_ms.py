"""Localizer construction: the mean of the program's ``loc.build`` spans
(``Localizer.__init__``: the map and vocabulary put on the device, the
extractor built, the BoW bank scored) in the traced part of the window, in
ms.

The spans are host intervals on the profiler's clock (``time.time_ns``),
recorded by ``se2lam_tpu_torch.utils.timing.RECORDER`` while the profiler
runs. The construction is host work and a few hundred launches at most;
the bank's scoring reads nothing back, so the interval ends when its last
launch is queued and its device work may end in the frame's next stage. A
program without the recorder reads None."""
from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    ms = [r.ms for r in rec.records("loc.build", run.trace.t0, run.trace.t1)]
    return sum(ms) / len(ms) if ms else None
