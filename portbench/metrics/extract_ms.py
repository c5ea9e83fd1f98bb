"""Extraction: the median device interval (CUDA events) of one
``OrbExtractor.forward`` call over the window, in ms."""
import statistics

SPANS = {"extract": "se2lam_tpu_torch.frontend.orb:OrbExtractor.forward"}


def read(run):
    ms = run.spans.get("extract")
    return statistics.median(ms) if ms else None
