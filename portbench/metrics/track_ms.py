"""Tracking: the median device interval of one ``tracking.track_frame``
call over the window, in ms."""
import statistics

SPANS = {"track": "se2lam_tpu_torch.tracking:track_frame"}


def read(run):
    ms = run.spans.get("track")
    return statistics.median(ms) if ms else None
