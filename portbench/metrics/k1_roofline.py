"""K1 (``csrc/fast_nms.cu``): the least time the card could take for the
traced launches over their summed device time, in %. Each launch takes
one frame's pyramid levels (``roofline.k1_work``)."""
from portbench.roofline import k1_work, least_seconds

KERNEL = "fast_nms_levels_kernel"


def read(run):
    if run.trace is None:
        return None
    n, secs = run.trace.kernels(KERNEL)
    if n == 0 or secs <= 0:
        return None
    sc = run.config["system"]
    s = [sc["scale_factor"] ** l for l in range(sc["max_level"])]
    shapes = [(int(round(sc["height"] / x)), int(round(sc["width"] / x))) for x in s]
    ops, nbytes = k1_work(shapes)
    return 100.0 * n * least_seconds(f32_ops=ops, nbytes=nbytes) / secs
