"""Relocalization: the mean of the ``candidates`` count of the program's
``loc.reloc`` spans (``Localizer._relocalize``) in the traced part of the
window: the BoW candidates, of the top 3 over the score gate, sent to
verification before one verified and refined, or all failed.

The counts are host values the program holds anyway, attached to spans
that ``se2lam_tpu_torch.utils.timing.RECORDER`` records while the profiler
runs. A program without the recorder reads None."""
from se2lam_tpu_torch.utils import timing


def read(run):
    rec = getattr(timing, "RECORDER", None)
    if run.trace is None or rec is None:
        return None
    n = [(r.counts or {}).get("candidates", 0)
         for r in rec.records("loc.reloc", run.trace.t0, run.trace.t1)]
    return sum(n) / len(n) if n else None
