"""K2 (``csrc/windowed_top2.cu``): the least time the card could take for the
traced launches over their summed device time, in %. Each launch's work
is counted from its inputs: the pairs its window and octave gate admits
(``roofline.k2_work``)."""
from portbench.roofline import k2_gated_pairs, k2_work, least_seconds

KERNEL = "windowed_top2_kernel"
HOLDS = {"k2_all": "se2lam_tpu_torch.frontend.windowed_match:windowed_top2"}


def read(run):
    if run.trace is None:
        return None
    n, secs = run.trace.kernels(KERNEL)
    kept = run.holds["k2_all"].kept
    if n == 0 or secs <= 0 or len(kept) != n:
        return None
    least = 0.0
    for _i, args, _kw, _out in kept:
        f32, i8, nbytes = k2_work(args[0].shape[0], args[6].shape[0], k2_gated_pairs(*args),
                                  sum(a.numel() * a.element_size() for a in args))
        least += least_seconds(f32_ops=f32, int8_ops=i8, nbytes=nbytes)
    return 100.0 * least / secs
