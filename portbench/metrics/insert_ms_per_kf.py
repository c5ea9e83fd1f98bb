"""Mapping: the mean device interval of one keyframe insertion
(``localmap.insert_and_optimize``, local BA included) over the window, in ms."""

SPANS = {"insert": "se2lam_tpu_torch.localmap:insert_and_optimize"}


def read(run):
    ms = run.spans.get("insert")
    return sum(ms) / len(ms) if ms else None
