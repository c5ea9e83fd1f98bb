"""Plain references of the port's solver outputs: the Schur point
reduction in float64, a damped Huber Gauss-Newton on one SE(2) pose
against fixed points, and the SE(2)-aligned trajectory error. Plain torch
and numpy, with no import of the port; each follows se2lam's own
definitions (EdgeSE2XYZ::computeError, src/EdgeSE2XYZ.cpp:61-72;
Localizer::DoLocalBA, src/Localizer.cpp:233-302)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["schur_reduction", "schur_error", "pose_only", "ate_se2"]


def schur_reduction(Hpx, Hxx_inv, dtype=torch.float64, tf32=False):
    """S[k, l] = Σ_m Hpx[k, :, m] · Hxx⁻¹[m] · Hpx[l, :, m]ᵀ as (K, K, 3, 3),
    computed in ``dtype`` (``tf32``: float32 products in TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        H, X = Hpx.to(dtype), Hxx_inv.to(dtype)
        T = torch.einsum("kamb,mbc->kamc", H, X)
        return torch.einsum("kamb,lcmb->klac", T, H)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def schur_error(S, Hpx, Hxx_inv):
    """|S − S₆₄| at its largest, over the largest entry of the same sum
    taken over the magnitudes |Hpx|, |Hxx⁻¹|: the scale to which a
    floating-point sum of these products is accurate. Weakly observed
    points make Hxx⁻¹ large along directions whose products cancel in S, so
    an error against max|S| would measure the cancellation, not the sum."""
    want = schur_reduction(Hpx, Hxx_inv)
    scale = float(schur_reduction(Hpx.abs(), Hxx_inv.abs()).abs().max())
    err = float((S.to(torch.float64) - want).abs().max())
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / scale


def _se2_to_se3(p):
    c, s = torch.cos(p[2]), torch.sin(p[2])
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z, p[0]]), torch.stack([s, c, z, p[1]]),
                        torch.stack([z, z, o, z]), torch.stack([z, z, z, o])])


def _residual(p, points, uv, K, Tcb):
    """e = π(Tcb · SE3(p)⁻¹ · X) − uv, with |z| kept from 0 (1e-4)."""
    c, s = torch.cos(p[2]), torch.sin(p[2])
    p_inv = torch.stack([-c * p[0] - s * p[1], s * p[0] - c * p[1], -p[2]])
    Tcw = Tcb @ _se2_to_se3(p_inv)
    lc = points @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = lc[:, 2]
    z = torch.where(z.abs() < 1e-4, torch.where(z < 0, -1e-4, 1e-4).to(z.dtype), z)
    fx, fy, cx, cy = K
    return torch.stack([fx * lc[:, 0] / z + cx, fy * lc[:, 1] / z + cy], -1) - uv


def _huber(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq > delta, 2.0 * delta * sq - delta * delta, c)


def pose_only(pose, points, uv, valid, K, Tcb, iters=30, huber_delta=5.0, lm_lambda=1e-4,
              dtype=torch.float64):
    """The pose that minimises Σ Huber(|e|²) over the valid points, from
    ``pose``: ``iters`` Levenberg-Marquardt steps on (x, y, θ), each taken
    only where the robust cost falls, in ``dtype``. ``K`` = (fx, fy, cx,
    cy), ``Tcb`` the 4x4 body-to-camera inverse."""
    dev = points.device
    p = pose.to(dtype)
    X, z, ok = points.to(dtype), uv.to(dtype), valid
    T = torch.as_tensor(Tcb, dtype=dtype, device=dev)
    Kd = [torch.tensor(k, dtype=dtype, device=dev) for k in K]

    def cost(q):
        c = (_residual(q, X, z, Kd, T) ** 2).sum(-1)
        return torch.where(ok, _huber(torch.clamp(c, max=1e6), huber_delta),
                           torch.zeros_like(c)).sum()

    lam = torch.tensor(lm_lambda, dtype=dtype, device=dev)
    last = cost(p)
    for _ in range(iters):
        r = _residual(p, X, z, Kd, T)
        J = torch.func.jacfwd(lambda q: _residual(q, X, z, Kd, T))(p)     # (M, 2, 3)
        sq = torch.sqrt(torch.clamp((r * r).sum(-1), min=1e-12))
        w = torch.where(sq > huber_delta, huber_delta / sq, torch.ones_like(sq))
        w = torch.where(ok, w, torch.zeros_like(w))
        H = torch.einsum("mai,m,maj->ij", J, w, J)
        b = -torch.einsum("mai,m,ma->i", J, w, r)
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * torch.eye(3, dtype=dtype, device=dev)
        # a 3x3 solve has no half-precision kernel: only it runs in float32
        cand = p + torch.linalg.solve(H.float() if dtype == torch.bfloat16 else H,
                                      b.float() if dtype == torch.bfloat16 else b).to(dtype)
        cand = torch.cat([cand[:2], torch.atan2(torch.sin(cand[2:]), torch.cos(cand[2:]))])
        new = cost(cand)
        accept = new < last
        p = torch.where(accept, cand, p)
        lam = torch.where(accept, lam * 0.5, lam * 10.0)
        last = torch.where(accept, new, last)
    return p


def ate_se2(est_xy, gt_xy):
    """RMSE of the position error after the best SE(2) alignment of the
    estimate onto the ground truth (2-D Umeyama without scale)."""
    est = np.asarray(est_xy, np.float64)
    gt = np.asarray(gt_xy, np.float64)
    E, G = est - est.mean(0), gt - gt.mean(0)
    th = np.arctan2((E[:, 0] * G[:, 1] - E[:, 1] * G[:, 0]).sum(), (E * G).sum())
    c, s = np.cos(th), np.sin(th)
    aligned = E @ np.array([[c, -s], [s, c]]).T + gt.mean(0)
    return float(np.sqrt((np.linalg.norm(aligned - gt, axis=1) ** 2).mean()))
