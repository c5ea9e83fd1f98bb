"""The yardstick of the kernels' roofline shares: the H100's published
peaks and, for each hand-written kernel, the operations and bytes its
inputs need (copied from ``chip_smoke.py``'s ``FAST_*_PER_PX``,
``k2_bound`` and ``schur_bound``; K3 here counts only the live keyframes
and points of a launch).

A share is the least time the card could take for the traced launches,
each the larger of its operations over the peak and its bytes over the
memory bandwidth, divided by the kernels' summed device time.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "INT8_OPS_PER_S", "k1_work", "k2_work",
           "k2_gated_pairs", "k3_work", "k3_live", "least_seconds"]

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12            # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # int8 tensor cores

# FAST+NMS per pixel: 4 B read, 3 maps of 4 B written; f32 operations: 16
# differences, 16 negations, 32 threshold subtractions, 32 clamps, 30 adds,
# 1 max, 64 threshold compares, 2 selects, 2 x (8 maxima + 2 compares +
# 1 select) for the two NMS maps
FAST_BYTES_PER_PX = 16
FAST_OPS_PER_PX = 16 + 16 + 32 + 32 + 30 + 1 + 64 + 2 + 2 * 11
# the window gate's operations on every pair: 2 differences, 2 absolute
# values, 2 window and 2 octave compares, 2 validity ands
K2_GATE_OPS = 10


def least_seconds(f32_ops=0.0, int8_ops=0.0, nbytes=0.0):
    """The larger of the compute time at the peaks and the memory time."""
    return max(f32_ops / F32_OPS_PER_S + int8_ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def k1_work(level_shapes):
    """(f32 ops, bytes) of one K1 launch over these (H, W) levels."""
    px = sum(h * w for h, w in level_shapes)
    return FAST_OPS_PER_PX * px, FAST_BYTES_PER_PX * px


def k2_work(n_rows, n_cols, gated_pairs, input_bytes):
    """(f32 ops, int8 ops, bytes) of one K2 launch: a 256-wide int8 dot
    product (512 operations) for each pair the gate admits, the gate on
    every pair, each input read once and 16 B of outputs a row written."""
    return (n_rows * n_cols * K2_GATE_OPS, gated_pairs * 512, input_bytes + 16 * n_rows)


def k3_work(live_kfs, live_points):
    """(f32 ops, bytes) of one K3 launch reduced to its live keyframes K and
    live points M: T = Hpx·Hxx⁻¹ and one triangle of the symmetric S,
    2·M·(9·3K + 3·3K(3K+1)/2) operations; Hpx, Hxx⁻¹ read once and S
    written once. Dead slots need no work, so a kernel that skips them
    still reads at most 100%."""
    R = 3 * live_kfs
    ops = 2 * live_points * (9 * R + 3 * R * (R + 1) // 2)
    nbytes = 4 * (9 * live_kfs * live_points + 9 * live_points + 9 * live_kfs * live_kfs)
    return ops, nbytes


def k2_gated_pairs(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2):
    """The pairs a K2 launch's window and octave gate admits (f32 tests)."""
    o2 = oct2.to(xy2.dtype)[None, :]
    gate = (((xy2[None, :, 0] - xy_pred[:, None, 0]).abs() <= win[:, None])
            & ((xy2[None, :, 1] - xy_pred[:, None, 1]).abs() <= win[:, None])
            & (o2 >= lvl_lo[:, None]) & (o2 <= lvl_hi[:, None])
            & valid1[:, None] & valid2[None, :])
    return int(gate.sum())


def k3_live(Hpx):
    """(live keyframes, live points) of a K3 launch's Hpx (K, 3, M, 3): the
    rows and the columns that hold a nonzero entry."""
    nz = Hpx != 0
    return int(nz.any(3).any(2).any(1).sum()), int(nz.any(3).any(1).any(0).sum())
