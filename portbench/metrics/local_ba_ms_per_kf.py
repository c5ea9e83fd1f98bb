"""Solver: the mean device interval of one local BA (``localmap.run_local_ba``,
K3 at the local window's shape) over the window, in ms."""

SPANS = {"local_ba": "se2lam_tpu_torch.localmap:run_local_ba"}


def read(run):
    ms = run.spans.get("local_ba")
    return sum(ms) / len(ms) if ms else None
