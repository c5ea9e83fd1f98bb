"""Relocalization: the mean device interval of one ``Localizer._relocalize``
call (BoW candidates, RANSAC verification, pose-only refinement) over the
window, in ms."""

SPANS = {"reloc": "se2lam_tpu_torch.localizer:Localizer._relocalize"}


def read(run):
    ms = run.spans.get("reloc")
    return sum(ms) / len(ms) if ms else None
