"""Pose-only Gauss-Newton: one free SE(2) pose against fixed map points
(port of se2lam_tpu.solver.poseonly; reference Localizer::DoLocalBA,
src/Localizer.cpp:233-302).

A damped 3×3 Gauss-Newton on (x, y, theta) with Huber weights, run as a
Python loop of ``iters`` steps. Each step accepts its candidate only if
the Huber-robustified cost falls; the loop reads nothing back to the host.
The damped normal matrix is symmetric positive definite, so the step is
solved by the unrolled Gauss-Jordan inverse of ``ops.linalg`` (a handful
of elementwise ops) rather than ``torch.linalg.solve``, whose one-matrix
LU took most of a tracked localization step on the card (``PERF.md``).

Under a fleet's ``torch.vmap`` the sums over the points (the cost, the
normal equations) and the 3x3 step take fixed-order forms
(``ops/fixed_order``), on the card and on the CPU alike (a batched einsum
sums in another order with the batch's size on either), so a robot's
solve is bitwise the same in a fleet of any size; an unbatched call keeps
the plain sums, except on the card within ``fixed_order.forced()`` (the
localizer's tracked step).
"""
from __future__ import annotations

import torch

from .. import factors
from ..ops import fixed_order, se2
from ..ops.camera import CameraModel
from ..ops.linalg import inv_psd_small

__all__ = ["solve_pose_only"]


def solve_pose_only(
    pose,          # (3,) initial SE2
    points,        # (M, 3) fixed world points
    uv,            # (M, 2) measurements
    valid,         # (M,) bool
    cam: CameraModel,
    Tcb,
    iters: int = 30,
    huber_delta: float = 5.0,   # Config::TH_HUBER (src/Config.cpp:155)
    lm_lambda: float = 1e-4,
):
    """Returns (pose, chi2, n_inliers): the robust cost the steps descend,
    and the valid observations whose squared residual at the end is below
    huber_delta²."""
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    fixed = fixed_order.batched(pose, points, uv, valid) or fixed_order.active(pose, points)

    def chi2_of(p):
        r = factors.se2xyz_residual(p, points, uv, cam, Tcb)
        c = (r * r).sum(dim=-1)
        rho = factors.huber_rho(torch.clamp(c, max=1e6), huber_delta)
        rho = torch.where(valid, rho, torch.zeros_like(rho))
        return (fixed_order.sum_halving(rho) if fixed else rho.sum()), c

    p = pose
    lam = torch.as_tensor(lm_lambda, dtype=pose.dtype, device=pose.device)
    last, _ = chi2_of(p)
    for _ in range(iters):
        r, Jp, _ = factors.se2xyz_residual_jac(p, points, uv, cam, Tcb)
        c = (r * r).sum(dim=-1)
        sqrt_c = torch.sqrt(torch.clamp(c, min=1e-12))
        w = torch.where(sqrt_c > huber_delta, huber_delta / sqrt_c, torch.ones_like(sqrt_c))
        w = torch.where(valid, w, torch.zeros_like(w))
        H, b = _normal_equations(Jp, w, r, fixed)
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
        Hinv = inv_psd_small(H)
        dp = fixed_order.rows_matvec(Hinv, b) if fixed else Hinv @ b
        cand = p + dp
        cand = torch.cat([cand[:2], se2.normalize_angle(cand[2:3])])
        new, _ = chi2_of(cand)
        accept = new < last
        p = torch.where(accept, cand, p)
        lam = torch.where(accept, lam * 0.5, lam * 10.0)
        last = torch.where(accept, new, last)
    _, c = chi2_of(p)
    n_inliers = (valid & (c < huber_delta ** 2)).sum(dtype=torch.int32)
    return p, last, n_inliers


def _normal_equations(Jp, w, r, fixed: bool):
    """H = Σ_m Jpᵀ w Jp and b = −Σ_m Jpᵀ w r over the points: the einsums,
    or (``fixed``) per-point blocks (sums over the two pixel rows) summed
    over the points in a fixed order."""
    if not fixed:
        return (torch.einsum("mai,m,maj->ij", Jp, w, Jp),
                -torch.einsum("mai,m,ma->i", Jp, w, r))
    wJ = Jp * w[:, None, None]
    Hm = (wJ[:, :, :, None] * Jp[:, :, None, :]).sum(1)
    bm = (wJ * r[:, :, None]).sum(1)
    return (fixed_order.sum_halving(Hm.movedim(0, -1)),
            -fixed_order.sum_halving(bm.movedim(0, -1)))
