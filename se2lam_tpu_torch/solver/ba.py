"""Batched Levenberg–Marquardt bundle adjustment with Schur elimination
(port of se2lam_tpu.solver.ba; the reference's g2o BlockSolverX +
Cholmod + Levenberg stack, include/se2lam/optimizer.h:30-34, on the
paper's SE2-XYZ graph, Map::loadLocalGraph, src/Map.cpp:891-1053).

Poses and points live in padded tensors with validity masks; invalid
entries contribute exact zeros to every Hessian block. The point blocks
are eliminated with a dense Schur complement (``schur.schur_reduce``,
kernel K3 on the card) and the reduced 3K×3K camera system is solved
densely. The LM loop runs ``iters`` steps as a Python loop that accepts
with ``torch.where`` and reads nothing back to the host.

The observation and odometry blocks are scatter-added in an order fixed
by their indices (``ops/fixed_order.index_add``): a solve on the card
gives the same bits every run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import factors
from ..ops import fixed_order, linalg, se2
from ..ops.camera import CameraModel
from .schur import schur_reduce

__all__ = [
    "BAProblem", "BAConfig", "solve_local_ba", "ba_chi2", "obs_chi2",
    "accumulate_obs", "synthetic_grid_ba",
]


class BAProblem(NamedTuple):
    """Fixed-capacity SE2-XYZ bundle-adjustment problem.

    K = max keyframes, M = max points, O = max observations, E = max odo edges.
    """

    poses: torch.Tensor        # (K, 3) SE2 (x, y, theta)
    points: torch.Tensor       # (M, 3) world XYZ
    pose_valid: torch.Tensor   # (K,) bool
    pose_fixed: torch.Tensor   # (K,) bool — fixed vertices
    point_valid: torch.Tensor  # (M,) bool

    obs_kf: torch.Tensor       # (O,) int — observing KF index
    obs_mp: torch.Tensor       # (O,) int — observed point index
    obs_uv: torch.Tensor       # (O, 2) undistorted pixel measurement
    obs_info: torch.Tensor     # (O, 2, 2) information
    obs_valid: torch.Tensor    # (O,) bool

    edge_i: torch.Tensor       # (E,) int — from-KF index
    edge_j: torch.Tensor       # (E,) int — to-KF index
    edge_meas: torch.Tensor    # (E, 3) preintegrated SE2 measurement
    edge_info: torch.Tensor    # (E, 3, 3) information
    edge_valid: torch.Tensor   # (E,) bool


class BAConfig(NamedTuple):
    iters: int = 10            # Config::LOCAL_ITER analog
    huber_delta: float = 5.0   # Config::TH_HUBER = sqrt(th_huber2=25)
    lm_init_lambda: float = 1e-4
    lm_up: float = 10.0
    lm_down: float = 0.5
    eps: float = 1e-9
    # >0 promises the observation axis is the M×P grid o = m*P + p, so
    # the point blocks accumulate by a reshape-sum
    obs_grid_p: int = 0
    # optional early exit: stop once an ACCEPTED step improves the robust
    # chi2 by less than term_rel (relative); 0 runs the whole budget, as
    # the reference does (src/LocalMapper.cpp:260)
    term_rel: float = 0.0


def synthetic_grid_ba(rng, K, M, P, cam, Tcb, step=(0.02, 0.005),
                      theta_step=(0.002, 0.001)):
    """Synthetic SE2-XYZ problem with the M×P observation grid (the JAX
    package's fixture of the same name, on the same numpy draws): exact
    projections as measurements, perturbed initial estimates. ``rng`` is
    a numpy Generator; ``cam`` and ``Tcb`` fix the device.
    Returns (BAProblem, true_poses)."""
    dev = Tcb.device
    O = M * P
    steps = rng.normal(step[0], step[1], (K, 3)).astype(np.float32)
    steps[:, 2] = rng.normal(theta_step[0], theta_step[1], K)
    poses = np.cumsum(steps, 0)
    anchor = rng.integers(0, K, M)
    points = np.stack(
        [
            poses[anchor, 0] + rng.uniform(4, 10, M),
            poses[anchor, 1] + rng.uniform(-3, 3, M),
            rng.uniform(-1, 1, M),
        ],
        -1,
    ).astype(np.float32)
    obs_mp = np.repeat(np.arange(M, dtype=np.int32), P)
    obs_kf = np.clip(anchor[obs_mp] + rng.integers(-6, 7, O), 0, K - 1).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    poses_t = t(poses)
    pj = poses_t[t(obs_kf).long()]
    xj = t(points)[t(obs_mp).long()]
    Tcw = Tcb @ torch.linalg.inv(se2.to_se3(pj))
    lc = torch.einsum("oij,oj->oi", Tcw[:, :3, :3], xj) + Tcw[:, :3, 3]
    z_ok = lc[:, 2] > 1.0
    zc = torch.clamp(lc[:, 2], min=1e-3)
    uv = torch.stack([cam.fx * lc[:, 0] / zc + cam.cx, cam.fy * lc[:, 1] / zc + cam.cy], -1)
    pose_fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    pose_fixed[0] = True
    prob = BAProblem(
        poses=t(poses + rng.normal(0, 0.005, (K, 3)).astype(np.float32)
                * np.asarray([1, 1, 0.3], np.float32)),
        points=t(points + rng.normal(0, 0.01, (M, 3)).astype(np.float32)),
        pose_valid=torch.ones(K, dtype=torch.bool, device=dev),
        pose_fixed=pose_fixed,
        point_valid=torch.ones(M, dtype=torch.bool, device=dev),
        obs_kf=t(obs_kf),
        obs_mp=t(obs_mp),
        obs_uv=uv,
        obs_info=torch.eye(2, device=dev).expand(O, 2, 2).contiguous(),
        obs_valid=z_ok,
        edge_i=torch.arange(K - 1, dtype=torch.int32, device=dev),
        edge_j=torch.arange(1, K, dtype=torch.int32, device=dev),
        edge_meas=se2.minus(poses_t[1:], poses_t[:-1]),
        edge_info=(2000.0 * torch.eye(3, device=dev)).expand(K - 1, 3, 3).contiguous(),
        edge_valid=torch.ones(K - 1, dtype=torch.bool, device=dev),
    )
    return prob, poses_t


def _obs_blocks(prob: BAProblem, cam: CameraModel, Tcb, huber_delta):
    """Residuals + weighted Jacobian blocks for all reprojection edges."""
    p = prob.poses[prob.obs_kf.long()]
    x = prob.points[prob.obs_mp.long()]
    r, Jp, Jx = factors.se2xyz_residual_jac(p, x, prob.obs_uv, cam, Tcb)
    z = factors.se2xyz_depth(p, x, Tcb)
    chi2 = torch.einsum("oi,oij,oj->o", r, prob.obs_info, r)
    # Huber: w = delta / sqrt(chi2) above the kink (g2o RobustKernelHuber)
    sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w_huber = torch.where(sqrt_chi > huber_delta, huber_delta / sqrt_chi,
                          torch.ones_like(sqrt_chi))
    # zero weight where the point sits at/behind the camera AT THE CURRENT
    # STATE (obs_valid is fixed at build time, LM steps move the state)
    w = torch.where(prob.obs_valid & (z > 1e-3), w_huber, torch.zeros_like(w_huber))
    W = prob.obs_info * w[:, None, None]
    return r, Jp, Jx, W, chi2


# chi2 ceiling for the accept cost: behind-camera observations are pinned
# AT the ceiling so they cancel between the accept sums, and an in-front
# observation's cost saturates at the same value
_CHI2_CAP = 1e6


def _obs_residual_depth(prob: BAProblem, cam: CameraModel, Tcb):
    """(residual, depth) per observation, without Jacobians."""
    p = prob.poses[prob.obs_kf.long()]
    x = prob.points[prob.obs_mp.long()]
    return (factors.se2xyz_residual(p, x, prob.obs_uv, cam, Tcb),
            factors.se2xyz_depth(p, x, Tcb))


def _edge_blocks(prob: BAProblem):
    r, Ji, Jj = factors.pre_se2_residual_jac(
        prob.poses[prob.edge_i.long()], prob.poses[prob.edge_j.long()], prob.edge_meas)
    W = torch.where(prob.edge_valid[:, None, None], prob.edge_info,
                    torch.zeros_like(prob.edge_info))
    chi2 = torch.einsum("ei,eij,ej->e", r, prob.edge_info, r)
    return r, Ji, Jj, W, chi2


def obs_chi2(prob: BAProblem, cam: CameraModel, Tcb):
    """Per-observation chi2 at the problem's current state."""
    r_o, _ = _obs_residual_depth(prob, cam, Tcb)
    return torch.einsum("oi,oij,oj->o", r_o, prob.obs_info, r_o)


def ba_chi2(prob: BAProblem, cam: CameraModel, Tcb, huber_delta=float("inf")):
    """Total masked cost of the problem (diagnostic + LM accept test): the
    Huber rho of each observation's chi2, behind-camera ones pinned at
    ``_CHI2_CAP``, plus the odometry edges' chi2."""
    r_o, z_o = _obs_residual_depth(prob, cam, Tcb)
    chi_o = torch.einsum("oi,oij,oj->o", r_o, prob.obs_info, r_o)
    r_e = factors.pre_se2_residual(
        prob.poses[prob.edge_i.long()], prob.poses[prob.edge_j.long()], prob.edge_meas)
    chi_e = torch.einsum("ei,eij,ej->e", r_e, prob.edge_info, r_e)
    cap = torch.full_like(chi_o, _CHI2_CAP)
    chi_c = torch.where(z_o > 1e-3, torch.minimum(chi_o, cap), cap)
    rho = factors.huber_rho(chi_c, huber_delta)
    zero_o, zero_e = torch.zeros_like(rho), torch.zeros_like(chi_e)
    return (torch.where(prob.obs_valid, rho, zero_o).sum()
            + torch.where(prob.edge_valid, chi_e, zero_e).sum())


def accumulate_obs(K, M, obs_kf, obs_mp, Hpp_o, Hxx_o, Hpx_o, bp_o, bx_o):
    """Scatter-add the per-observation weighted blocks into the dense
    structures: Hpp (K,K,3,3) — observations touch only its diagonal
    blocks — bp (K,3), Hxx (M,3,3), bx (M,3), Hpx (K,3,M,3). The JAX
    package's scatter lowering (``ba.py:309-317``). Invalid observations
    carry zero W blocks, so their in-range indices add exact zeros."""
    dtype, dev = Hpp_o.dtype, Hpp_o.device
    kf, mp = obs_kf.long(), obs_mp.long()
    Hxx = fixed_order.index_add_(torch.zeros((M, 3, 3), dtype=dtype, device=dev), obs_mp, Hxx_o)
    bx = fixed_order.index_add_(torch.zeros((M, 3), dtype=dtype, device=dev), obs_mp, bx_o)
    Hpp = torch.zeros((K, K, 3, 3), dtype=dtype, device=dev)
    Hpp.index_put_((kf, kf), Hpp_o, accumulate=True)
    bp = fixed_order.index_add_(torch.zeros((K, 3), dtype=dtype, device=dev), obs_kf, bp_o)
    Hpx = torch.zeros((K, 3, M, 3), dtype=dtype, device=dev)
    # [k, m] blocks through the (K, M, 3, 3) view of the [k,a],[m,b] layout
    Hpx.permute(0, 2, 1, 3).index_put_((kf, mp), Hpx_o, accumulate=True)
    return Hpp, bp, Hxx, bx, Hpx


def _assemble(prob: BAProblem, cam: CameraModel, Tcb, cfg: BAConfig):
    """Build the dense reduced-system pieces.

    Returns (Hpp (K,K,3,3), bp (K,3), Hxx (M,3,3), bx (M,3),
             Hpx (K,3,M,3), chi2_total).
    """
    K = prob.poses.shape[0]
    M = prob.points.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device

    r_o, Jp, Jx, Wo, chi_o = _obs_blocks(prob, cam, Tcb, cfg.huber_delta)
    r_e, Ji, Jj, We, chi_e = _edge_blocks(prob)

    # per-observation weighted blocks: JᵀW then JᵀWJ
    JpW = torch.einsum("oab,oac->obc", Jp, Wo)        # (O, 3, 2) = Jpᵀ W
    JxW = torch.einsum("oab,oac->obc", Jx, Wo)
    Hpp_o = JpW @ Jp
    Hxx_o = JxW @ Jx
    Hpx_o = JpW @ Jx
    bp_o = -torch.einsum("oab,ob->oa", JpW, r_o)
    bx_o = -torch.einsum("oab,ob->oa", JxW, r_o)

    if cfg.obs_grid_p > 0:
        # grid layout o = m*P + p: points reshape-sum, poses one-hot over K
        P = cfg.obs_grid_p
        Hxx = Hxx_o.reshape(M, P, 3, 3).sum(1)
        bx = bx_o.reshape(M, P, 3).sum(1)
        A2 = (prob.obs_kf.reshape(M, P)[:, :, None]
              == torch.arange(K, device=dev)[None, None, :]).to(dtype)
        Hpp_diag = torch.einsum("mpk,mpab->kab", A2, Hpp_o.reshape(M, P, 3, 3))
        Hpp = torch.zeros((K, K, 3, 3), dtype=dtype, device=dev)
        diag = torch.arange(K, device=dev)
        Hpp[diag, diag] += Hpp_diag
        bp = torch.einsum("mpk,mpa->ka", A2, bp_o.reshape(M, P, 3))
        # einsum returns a permuted view; the kernel takes Hpx contiguous
        Hpx = torch.einsum("mpk,mpab->kamb", A2, Hpx_o.reshape(M, P, 3, 3)).contiguous()
    else:
        Hpp, bp, Hxx, bx, Hpx = accumulate_obs(
            K, M, prob.obs_kf, prob.obs_mp, Hpp_o, Hxx_o, Hpx_o, bp_o, bx_o)

    # odometry edges
    ei, ej = prob.edge_i.long(), prob.edge_j.long()
    JiW = torch.einsum("eab,eac->ebc", Ji, We)
    JjW = torch.einsum("eab,eac->ebc", Jj, We)
    Hpp.index_put_((ei, ei), JiW @ Ji, accumulate=True)
    Hpp.index_put_((ei, ej), JiW @ Jj, accumulate=True)
    Hpp.index_put_((ej, ei), JjW @ Ji, accumulate=True)
    Hpp.index_put_((ej, ej), JjW @ Jj, accumulate=True)
    fixed_order.index_add_(bp, prob.edge_i, -torch.einsum("eab,eb->ea", JiW, r_e))
    fixed_order.index_add_(bp, prob.edge_j, -torch.einsum("eab,eb->ea", JjW, r_e))

    chi2_total = (torch.where(prob.obs_valid, chi_o, torch.zeros_like(chi_o)).sum()
                  + torch.where(prob.edge_valid, chi_e, torch.zeros_like(chi_e)).sum())
    return Hpp, bp, Hxx, bx, Hpx, chi2_total


def _fix_gauge(Hpp_d, bp_d, free3):
    """Fix variables by zeroing their rows/cols and unit diagonal.
    free3: (3K,) 1.0 for free coordinates, 0.0 for fixed."""
    Hpp_d = Hpp_d * free3[:, None] * free3[None, :]
    Hpp_d = Hpp_d + torch.diag(1.0 - free3)
    return Hpp_d, bp_d * free3


def _floored_diag(H):
    """Per-block diagonals floored at 1e-3 of the block's stiffest
    direction (+1e-6): Marquardt damping then bounds the step along
    near-null directions too (``ba.py:455-485``)."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return torch.maximum(d, 1e-3 * d.amax(dim=-1, keepdim=True) + 1e-6)


def damped_system(prob, cam, Tcb, cfg, lam):
    """The system one LM step solves: (Hpp, bp, Hpx, Hxx⁻¹, bx, chi2) with
    Marquardt damping λ·diag on the block diagonals and the point blocks
    inverted — the inputs of ``schur_reduce``."""
    K = prob.poses.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device

    Hpp, bp, Hxx, bx, Hpx, chi2 = _assemble(prob, cam, Tcb, cfg)

    # Marquardt damping λ·diag(H) on the block diagonals
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    diag = torch.arange(K, device=dev)
    dpp = _floored_diag(Hpp[diag, diag])
    Hpp[diag, diag] += lam * dpp[..., None] * eye3[None]
    Hxx = Hxx + lam * _floored_diag(Hxx)[..., None] * eye3[None]

    # invalid points get identity (their Hpx columns are zero)
    Hxx_safe = torch.where(prob.point_valid[:, None, None], Hxx + cfg.eps * eye3[None],
                           eye3[None].expand_as(Hxx))
    return Hpp, bp, Hpx, linalg.inv3x3(Hxx_safe), bx, chi2


def _solve_inner(prob, cam, Tcb, cfg, lam):
    """One damped GN step; returns (dpose, dpoint, chi2_before)."""
    K = prob.poses.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device
    Hpp, bp, Hpx, Hxx_inv, bx, chi2 = damped_system(prob, cam, Tcb, cfg, lam)

    S, b_red = schur_reduce(Hpp, bp, Hpx, Hxx_inv, bx)

    S_d = S.permute(0, 2, 1, 3).reshape(3 * K, 3 * K)
    b_d = b_red.reshape(3 * K)
    free = prob.pose_valid & ~prob.pose_fixed
    free3 = free.to(dtype).repeat_interleave(3)
    S_d, b_d = _fix_gauge(S_d, b_d, free3)

    # dense solve; the system is symmetric PD
    dp = torch.linalg.solve(S_d + cfg.eps * torch.eye(3 * K, dtype=dtype, device=dev), b_d)
    dp = (dp * free3).reshape(K, 3)

    # back-substitute points: dx = Hxx⁻¹ (bx − Hpxᵀ dp)
    rhs_x = bx - torch.einsum("kamb,ka->mb", Hpx, dp)
    dx = torch.einsum("mab,mb->ma", Hxx_inv, rhs_x)
    dx = torch.where(prob.point_valid[:, None], dx, torch.zeros_like(dx))
    return dp, dx, chi2


def solve_local_ba(prob: BAProblem, cam: CameraModel, Tcb, cfg: BAConfig = BAConfig()):
    """Run the LM loop; returns (poses, points, info dict).

    g2o's VertexSE2 oplus is additive in (x, y, theta) with angle
    normalization; steps are accepted on the robust cost. With
    ``term_rel == 0`` exactly ``iters`` steps run; otherwise a ``done``
    flag freezes the state after the first accepted step that gains less
    than ``term_rel`` (relative), and ``info["iters"]`` counts the steps
    taken, as the JAX ``while_loop`` does.
    """
    dev = prob.poses.device
    lam = torch.tensor(cfg.lm_init_lambda, dtype=prob.poses.dtype, device=dev)
    chi0 = ba_chi2(prob, cam, Tcb, cfg.huber_delta)
    last = chi0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    n_it = torch.zeros((), dtype=torch.int32, device=dev)
    poses, points = prob.poses, prob.points
    for _ in range(cfg.iters):
        cur = prob._replace(poses=poses, points=points)
        dp, dx, _ = _solve_inner(cur, cam, Tcb, cfg, lam)
        new_poses = poses + dp
        new_poses = torch.cat([new_poses[:, :2], se2.normalize_angle(new_poses[:, 2:3])], dim=1)
        new_points = points + dx
        new_chi2 = ba_chi2(cur._replace(poses=new_poses, points=new_points), cam, Tcb,
                           cfg.huber_delta)
        accept = new_chi2 < last
        live = ~done
        take = accept & live
        poses = torch.where(take, new_poses, poses)
        points = torch.where(take, new_points, points)
        lam = torch.where(live, torch.where(accept, lam * cfg.lm_down, lam * cfg.lm_up), lam)
        n_it = n_it + live.to(torch.int32)
        if cfg.term_rel > 0:
            done = done | (take & (last - new_chi2 <= cfg.term_rel * last))
        last = torch.where(take, new_chi2, last)
    return poses, points, {"chi2": last, "chi2_init": chi0, "lambda": lam, "iters": n_it}
