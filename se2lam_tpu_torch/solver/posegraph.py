"""Global SE(2) pose-graph Levenberg–Marquardt solver (port of
se2lam_tpu.solver.posegraph; the reference GlobalBA,
GlobalMapper::GlobalBA, src/GlobalMapper.cpp:328-535).

Every keyframe is an (x, y, theta) vertex; odometry and loop/feature
constraints are preintegrated-SE2 relative edges (PreEdgeSE2). The dense
3K×3K normal matrix is assembled with accumulating scatters (repeated
edges add up) and solved by ``torch.linalg.solve`` (pivoted LU; TF32 is
off on the card, ``device.resolve_device``). Fixed vertices (the gauge)
get zero rows and columns and a unit diagonal. The LM loop is a Python
loop of ``iters`` steps that accepts with ``torch.where`` and reads
nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import factors
from ..device import resolve_device
from ..ops import fixed_order, se2

__all__ = [
    "PoseGraphProblem", "solve_pose_graph", "pose_graph_chi2", "synthetic_pose_graph",
]


class PoseGraphProblem(NamedTuple):
    poses: torch.Tensor       # (K, 3) SE2
    pose_valid: torch.Tensor  # (K,) bool
    pose_fixed: torch.Tensor  # (K,) bool (gauge anchors, e.g. KF0)
    edge_i: torch.Tensor      # (E,) int32
    edge_j: torch.Tensor      # (E,) int32
    edge_meas: torch.Tensor   # (E, 3) relative SE2 (j in i's frame)
    edge_info: torch.Tensor   # (E, 3, 3)
    edge_valid: torch.Tensor  # (E,) bool


def synthetic_pose_graph(rng, K: int, loop_pairs=None, n_random_loops: int = 0,
                         step_mu: float = 0.08, step_sigma: float = 0.02,
                         meas_noise: float = 0.002, pose_noise: float = 0.03,
                         edge_info_scale: float = 100.0, device=None):
    """Chain + loop-closure fixture on the JAX package's numpy draws
    (``rng`` a ``np.random.Generator``): odometry edges chain 0..K-1,
    ``loop_pairs`` adds explicit (i, j) closures, ``n_random_loops``
    samples long-range ones; KF0 is the gauge anchor, its noise zeroed.
    ``device=None`` means the card (``device.resolve_device``)."""
    gt = np.cumsum(rng.normal(step_mu, step_sigma, (K, 3)).astype(np.float32), 0)
    ei = list(range(K - 1))
    ej = list(range(1, K))
    for a, b in (loop_pairs or []):
        ei.append(int(a))
        ej.append(int(b))
    for _ in range(n_random_loops):
        a = int(rng.integers(0, K - 30))
        b = int(rng.integers(a + 25, K))
        ei.append(a)
        ej.append(b)
    ei = np.asarray(ei, np.int32)
    ej = np.asarray(ej, np.int32)
    E = len(ei)
    gt_t = torch.from_numpy(gt)
    meas = se2.minus(gt_t[torch.from_numpy(ej).long()], gt_t[torch.from_numpy(ei).long()]).numpy()
    meas = meas + rng.normal(0, meas_noise, (E, 3)).astype(np.float32)
    noise = rng.normal(0, pose_noise, gt.shape).astype(np.float32)
    noise[0] = 0
    fixed = np.zeros(K, bool)
    fixed[0] = True

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return PoseGraphProblem(
        poses=t(gt + noise),
        pose_valid=t(np.ones(K, bool)),
        pose_fixed=t(fixed),
        edge_i=t(ei),
        edge_j=t(ej),
        edge_meas=t(meas.astype(np.float32)),
        edge_info=t(np.broadcast_to(edge_info_scale * np.eye(3, dtype=np.float32), (E, 3, 3))),
        edge_valid=t(np.ones(E, bool)),
    )


def _edge_terms(prob: PoseGraphProblem, huber_delta):
    r, Ji, Jj = factors.pre_se2_residual_jac(
        prob.poses[prob.edge_i.long()], prob.poses[prob.edge_j.long()], prob.edge_meas)
    chi2 = torch.einsum("ei,eij,ej->e", r, prob.edge_info, r)
    sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w = torch.where(sqrt_chi > huber_delta, huber_delta / sqrt_chi, torch.ones_like(sqrt_chi))
    W = prob.edge_info * torch.where(prob.edge_valid, w, torch.zeros_like(w))[:, None, None]
    return r, Ji, Jj, W, chi2


def pose_graph_chi2(prob: PoseGraphProblem, huber_delta=float("inf")):
    """Σ over valid edges of the Huber ρ of each edge's chi2."""
    _, _, _, _, chi2 = _edge_terms(prob, float("inf"))
    rho = factors.huber_rho(chi2, huber_delta)
    return torch.where(prob.edge_valid, rho, torch.zeros_like(rho)).sum()


def _assemble(p: PoseGraphProblem, huber_delta):
    K = p.poses.shape[0]
    dtype, dev = p.poses.dtype, p.poses.device
    r, Ji, Jj, W, _ = _edge_terms(p, huber_delta)
    JiW = torch.einsum("eab,eac->ebc", Ji, W)
    JjW = torch.einsum("eab,eac->ebc", Jj, W)
    ei, ej = p.edge_i.long(), p.edge_j.long()
    H = torch.zeros((K, K, 3, 3), dtype=dtype, device=dev)
    H.index_put_((ei, ei), JiW @ Ji, accumulate=True)
    H.index_put_((ei, ej), JiW @ Jj, accumulate=True)
    H.index_put_((ej, ei), JjW @ Ji, accumulate=True)
    H.index_put_((ej, ej), JjW @ Jj, accumulate=True)
    b = torch.zeros((K, 3), dtype=dtype, device=dev)
    fixed_order.index_add_(b, p.edge_i, -torch.einsum("eab,eb->ea", JiW, r))
    fixed_order.index_add_(b, p.edge_j, -torch.einsum("eab,eb->ea", JjW, r))
    return H, b


def solve_pose_graph(prob: PoseGraphProblem, iters: int = 15,
                     huber_delta: float = float("inf"), lm_init_lambda: float = 1e-6):
    """Bounded LM loop (Config::GLOBAL_ITER = 15 analog). Returns
    (poses, {"chi2", "chi2_init"})."""
    K = prob.poses.shape[0]
    dtype, dev = prob.poses.dtype, prob.poses.device
    free = prob.pose_valid & ~prob.pose_fixed
    free3 = free.to(dtype).repeat_interleave(3)
    eye = torch.eye(3 * K, dtype=dtype, device=dev)

    chi0 = pose_graph_chi2(prob, huber_delta)
    p, lam, last = prob, torch.tensor(lm_init_lambda, dtype=dtype, device=dev), chi0
    for _ in range(iters):
        H, b = _assemble(p, huber_delta)
        Hd = H.permute(0, 2, 1, 3).reshape(3 * K, 3 * K)
        Hd = Hd + lam * torch.diag(torch.diagonal(Hd)) + 1e-9 * eye
        Hd = Hd * free3[:, None] * free3[None, :] + torch.diag(1.0 - free3)
        dp = torch.linalg.solve(Hd, b.reshape(-1) * free3).reshape(K, 3)
        new_poses = p.poses + dp * free[:, None]
        new_poses = torch.cat([new_poses[:, :2], se2.normalize_angle(new_poses[:, 2:3])], 1)
        new_chi2 = pose_graph_chi2(p._replace(poses=new_poses), huber_delta)
        accept = new_chi2 < last
        p = p._replace(poses=torch.where(accept, new_poses, p.poses))
        lam = torch.where(accept, lam * 0.5, lam * 10.0)
        last = torch.where(accept, new_chi2, last)
    return p.poses, {"chi2": last, "chi2_init": chi0}
