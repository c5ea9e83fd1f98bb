"""K3 (``csrc/schur_reduce.cu``): the least time the card could take for the
traced launches over their summed device time, in %. Each launch is
counted for its live keyframes and live points (rows and columns of Hpx
with a nonzero entry, ``roofline.k3_work``), the work its inputs need."""
from portbench.roofline import k3_live, k3_work, least_seconds

KERNEL = "schur_reduce_kernel"
HOLDS = {"k3_all": "se2lam_tpu_torch.solver.schur:point_reduction"}


def read(run):
    if run.trace is None:
        return None
    n, secs = run.trace.kernels(KERNEL)
    kept = run.holds["k3_all"].kept
    if n == 0 or secs <= 0 or len(kept) != n:
        return None
    least = 0.0
    for _i, args, _kw, _out in kept:
        ops, nbytes = k3_work(*k3_live(args[0]))
        least += least_seconds(f32_ops=ops, nbytes=nbytes)
    return 100.0 * least / secs
