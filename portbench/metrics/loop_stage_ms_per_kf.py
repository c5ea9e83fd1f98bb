"""Loop closing: the device intervals of ``loopclose.loop_stage`` (detection,
verification, and the closure branch where it fires: merge, pose graph,
joint GBA) summed over the window, over the window's keyframes, in ms."""

SPANS = {"loop_stage": "se2lam_tpu_torch.loopclose:loop_stage"}


def read(run):
    ms = run.spans.get("loop_stage")
    kfs = run.counts.get("keyframes", 0)
    return sum(ms) / kfs if ms and kfs else None
