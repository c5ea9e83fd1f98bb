"""Localizer tracked step: the median device interval of one
``localizer._localize_step`` (projection, K2 match, 30-step pose-only solve)
over the window, in ms."""
import statistics

SPANS = {"localize_step": "se2lam_tpu_torch.localizer:_localize_step"}


def read(run):
    ms = run.spans.get("localize_step")
    return statistics.median(ms) if ms else None
