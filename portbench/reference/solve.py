"""Plain float64 re-solves of the port's bundle adjustment (local BA and
the joint GBA) and pose graph, from the problem the program built, and
the measure that compares the program's solution with them.

Each follows se2lam's graph (EdgeSE2XYZ, src/EdgeSE2XYZ.cpp:61-106;
PreEdgeSE2, include/se2lam/EdgeSE2XYZ.h:62-102; g2o's Levenberg with a
Huber kernel): the robust cost, Levenberg-Marquardt steps with Marquardt
damping on each block's diagonal, the fixed vertices held, each step
taken only where the robust cost falls. Jacobians come from
``torch.func.jacfwd`` of the residuals. Plain torch with no import of the
port: a problem is any object with the fields of the port's ``BAProblem``
or ``PoseGraphProblem``.
"""
from __future__ import annotations

import math

import torch
from torch.func import jacfwd, vmap

__all__ = ["ba_cost", "solve_ba", "pose_graph_cost", "solve_pose_graph", "shortfall"]

_CAP = 1e6          # an observation's chi2 ceiling; at or behind the camera it sits there


def _wrap(t):
    # the turns are a constant to the derivative (forward mode would carry
    # floor's tangent in float64)
    turns = torch.floor((t + math.pi) / (2.0 * math.pi)).detach()
    return t - 2.0 * math.pi * turns


def _rot(t):
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _cam_point(pose, X, Tcb):
    """Tcb · SE3(pose)⁻¹ · X for one pose (3,) and point (3,)."""
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    d = X[:2] - pose[:2]
    body = torch.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1], X[2]])
    return Tcb[:3, :3] @ body + Tcb[:3, 3]


def _obs_residual(pose, X, uv, K, Tcb):
    lc = _cam_point(pose, X, Tcb)
    z = lc[2]
    z = torch.where(z.abs() < 1e-4, torch.where(z < 0, -1e-4, 1e-4).to(z.dtype), z)
    return torch.stack([K[0] * lc[0] / z + K[2], K[1] * lc[1] / z + K[3]]) - uv


def _obs_depth(pose, X, Tcb):
    return _cam_point(pose, X, Tcb)[2]


def _edge_residual(pi, pj, meas):
    e = _rot(pi[2]).T @ (pj[:2] - pi[:2]) - meas[:2]
    return torch.cat([e, _wrap(pj[2] - pi[2] - meas[2])[None]])


def _huber_rho(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq > delta, 2.0 * delta * sq - delta * delta, c)


def _huber_w(c, delta):
    sq = torch.sqrt(torch.clamp(c, min=1e-12))
    return torch.where(sq > delta, delta / sq, torch.ones_like(sq))


class _BA:
    """A problem's live observations and edges in ``dtype``."""

    def __init__(self, prob, K, Tcb, dtype):
        dev = prob.poses.device
        self.K = torch.tensor(K, dtype=dtype, device=dev)
        self.Tcb = torch.as_tensor(Tcb, dtype=dtype, device=dev)
        o = prob.obs_valid.nonzero()[:, 0]
        self.okf, self.omp = prob.obs_kf[o].long(), prob.obs_mp[o].long()
        self.uv, self.info = prob.obs_uv[o].to(dtype), prob.obs_info[o].to(dtype)
        e = prob.edge_valid.nonzero()[:, 0]
        self.ei, self.ej = prob.edge_i[e].long(), prob.edge_j[e].long()
        self.meas, self.einfo = prob.edge_meas[e].to(dtype), prob.edge_info[e].to(dtype)
        self.free = (prob.pose_valid & ~prob.pose_fixed)
        self.point_valid = prob.point_valid

    def obs(self, poses, points):
        p, X = poses[self.okf], points[self.omp]
        r = vmap(_obs_residual, (0, 0, 0, None, None))(p, X, self.uv, self.K, self.Tcb)
        z = vmap(_obs_depth, (0, 0, None))(p, X, self.Tcb)
        return p, X, r, z

    def cost(self, poses, points, delta):
        _, _, r, z = self.obs(poses, points)
        chi = torch.einsum("oi,oij,oj->o", r, self.info, r)
        chi = torch.where(z > 1e-3, torch.clamp(chi, max=_CAP), torch.full_like(chi, _CAP))
        re = vmap(_edge_residual)(poses[self.ei], poses[self.ej], self.meas)
        return (_huber_rho(chi, delta).sum()
                + torch.einsum("ei,eij,ej->e", re, self.einfo, re).sum())


def ba_cost(prob, K, Tcb, poses, points, huber, dtype=torch.float64):
    """The robust cost of ``prob`` at (poses, points), as the LM accept
    test takes it: Huber ρ of each live observation's chi2 (at or behind
    the camera: the ceiling), plus the odometry edges' chi2."""
    ba = _BA(prob, K, Tcb, dtype)
    return float(ba.cost(poses.to(dtype), points.to(dtype), huber))


def _floored(d):
    return torch.maximum(d, 1e-3 * d.amax(-1, keepdim=True) + 1e-6)


def solve_ba(prob, K, Tcb, iters, huber, lam0, eps=1e-9, dtype=torch.float64, tf32=False):
    """``iters`` LM steps on ``prob`` from its state; returns (poses,
    points) in ``dtype`` (``tf32``: float32 products in TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _solve_ba(prob, K, Tcb, iters, huber, lam0, eps, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _solve_ba(prob, K, Tcb, iters, huber, lam0, eps, dtype):
    ba = _BA(prob, K, Tcb, dtype)
    dev = prob.poses.device
    nK, nM = prob.poses.shape[0], prob.points.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    free3 = ba.free.to(dtype).repeat_interleave(3)
    poses, points = prob.poses.to(dtype), prob.points.to(dtype)
    lam = lam0
    last = ba.cost(poses, points, huber)
    jac_o = vmap(jacfwd(_obs_residual, argnums=(0, 1)), (0, 0, 0, None, None))
    jac_e = vmap(jacfwd(_edge_residual, argnums=(0, 1)))
    for _ in range(iters):
        p, X, r, z = ba.obs(poses, points)
        Jp, Jx = jac_o(p, X, ba.uv, ba.K, ba.Tcb)
        chi = torch.einsum("oi,oij,oj->o", r, ba.info, r)
        w = torch.where(z > 1e-3, _huber_w(chi, huber), torch.zeros_like(chi))
        W = ba.info * w[:, None, None]
        JpW = torch.einsum("oab,oac->obc", Jp, W)
        JxW = torch.einsum("oab,oac->obc", Jx, W)
        Hpp = torch.zeros((nK, nK, 3, 3), dtype=dtype, device=dev)
        Hpp.index_put_((ba.okf, ba.okf), JpW @ Jp, accumulate=True)
        Hxx = torch.zeros((nM, 3, 3), dtype=dtype, device=dev).index_add_(0, ba.omp, JxW @ Jx)
        Hpx = torch.zeros((nK, nM, 3, 3), dtype=dtype, device=dev)
        Hpx.index_put_((ba.okf, ba.omp), JpW @ Jx, accumulate=True)
        bp = torch.zeros((nK, 3), dtype=dtype, device=dev).index_add_(
            0, ba.okf, -torch.einsum("oab,ob->oa", JpW, r))
        bx = torch.zeros((nM, 3), dtype=dtype, device=dev).index_add_(
            0, ba.omp, -torch.einsum("oab,ob->oa", JxW, r))
        re = vmap(_edge_residual)(poses[ba.ei], poses[ba.ej], ba.meas)
        Ji, Jj = jac_e(poses[ba.ei], poses[ba.ej], ba.meas)
        JiW = torch.einsum("eab,eac->ebc", Ji, ba.einfo)
        JjW = torch.einsum("eab,eac->ebc", Jj, ba.einfo)
        for a, Ja, JaW in ((ba.ei, Ji, JiW), (ba.ej, Jj, JjW)):
            for b_, Jb in ((ba.ei, Ji), (ba.ej, Jj)):
                Hpp.index_put_((a, b_), JaW @ Jb, accumulate=True)
            bp.index_add_(0, a, -torch.einsum("eab,eb->ea", JaW, re))
        diag = torch.arange(nK, device=dev)
        Hpp[diag, diag] += lam * _floored(torch.diagonal(Hpp[diag, diag], 0, -2, -1))[..., None] * eye3
        Hxx = Hxx + lam * _floored(torch.diagonal(Hxx, 0, -2, -1))[..., None] * eye3
        Hxx = torch.where(ba.point_valid[:, None, None], Hxx + eps * eye3, eye3.expand_as(Hxx))
        Hxx_inv = torch.linalg.inv(Hxx)
        T = torch.einsum("kmab,mbc->kmac", Hpx, Hxx_inv)
        S = Hpp - torch.einsum("kmab,lmcb->klac", T, Hpx)
        b_red = bp - torch.einsum("kmab,mb->ka", T, bx)
        S = S.permute(0, 2, 1, 3).reshape(3 * nK, 3 * nK) * free3[:, None] * free3[None, :]
        S = S + torch.diag(1.0 - free3) + eps * torch.eye(3 * nK, dtype=dtype, device=dev)
        dp = (torch.linalg.solve(S, b_red.reshape(-1) * free3) * free3).reshape(nK, 3)
        dx = torch.einsum("mab,mb->ma", Hxx_inv, bx - torch.einsum("kmab,ka->mb", Hpx, dp))
        dx = torch.where(ba.point_valid[:, None], dx, torch.zeros_like(dx))
        cand = poses + dp
        cand = torch.cat([cand[:, :2], _wrap(cand[:, 2:3])], 1)
        cand_x = points + dx
        new = ba.cost(cand, cand_x, huber)
        if bool(new < last):
            poses, points, last, lam = cand, cand_x, new, lam * 0.5
        else:
            lam = lam * 10.0
    return poses, points


def _pg_edges(prob, dtype):
    e = prob.edge_valid.nonzero()[:, 0]
    return (prob.edge_i[e].long(), prob.edge_j[e].long(), prob.edge_meas[e].to(dtype),
            prob.edge_info[e].to(dtype))


def _pg_cost(poses, ei, ej, meas, info, huber):
    r = vmap(_edge_residual)(poses[ei], poses[ej], meas)
    return _huber_rho(torch.einsum("ei,eij,ej->e", r, info, r), huber).sum()


def pose_graph_cost(prob, poses, huber, dtype=torch.float64):
    """Σ over live edges of the Huber ρ of each edge's chi2."""
    return float(_pg_cost(poses.to(dtype), *_pg_edges(prob, dtype), huber))


def solve_pose_graph(prob, iters, huber, lam0=1e-6, dtype=torch.float64, tf32=False):
    """``iters`` LM steps on the pose graph from its state; returns the
    poses in ``dtype``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ei, ej, meas, info = _pg_edges(prob, dtype)
        dev = prob.poses.device
        nK = prob.poses.shape[0]
        free = prob.pose_valid & ~prob.pose_fixed
        free3 = free.to(dtype).repeat_interleave(3)
        eye = torch.eye(3 * nK, dtype=dtype, device=dev)
        poses, lam = prob.poses.to(dtype), lam0
        last = _pg_cost(poses, ei, ej, meas, info, huber)
        jac = vmap(jacfwd(_edge_residual, argnums=(0, 1)))
        for _ in range(iters):
            r = vmap(_edge_residual)(poses[ei], poses[ej], meas)
            Ji, Jj = jac(poses[ei], poses[ej], meas)
            w = _huber_w(torch.einsum("ei,eij,ej->e", r, info, r), huber)
            W = info * w[:, None, None]
            H = torch.zeros((nK, nK, 3, 3), dtype=dtype, device=dev)
            b = torch.zeros((nK, 3), dtype=dtype, device=dev)
            for a, Ja in ((ei, Ji), (ej, Jj)):
                JaW = torch.einsum("eab,eac->ebc", Ja, W)
                for c, Jc in ((ei, Ji), (ej, Jj)):
                    H.index_put_((a, c), JaW @ Jc, accumulate=True)
                b.index_add_(0, a, -torch.einsum("eab,eb->ea", JaW, r))
            Hd = H.permute(0, 2, 1, 3).reshape(3 * nK, 3 * nK)
            Hd = Hd + lam * torch.diag(torch.diagonal(Hd)) + 1e-9 * eye
            Hd = Hd * free3[:, None] * free3[None, :] + torch.diag(1.0 - free3)
            dp = torch.linalg.solve(Hd, b.reshape(-1) * free3).reshape(nK, 3) * free[:, None]
            cand = poses + dp
            cand = torch.cat([cand[:, :2], _wrap(cand[:, 2:3])], 1)
            new = _pg_cost(cand, ei, ej, meas, info, huber)
            if bool(new < last):
                poses, last, lam = cand, new, lam * 0.5
            else:
                lam = lam * 10.0
        return poses
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def shortfall(c_init: float, c_got: float, c_want: float) -> float:
    """The share of the reference's fall in cost that a solution misses:
    (c_got − c_want) / (c_init − c_want). A solve that returns its input
    reads 1; one that matches the reference reads 0; one that ends lower
    reads below 0. Where the reference finds nothing to gain, a solution
    no costlier than the input reads 0."""
    gain = c_init - c_want
    if not gain > 1e-12 * max(abs(c_init), 1.0):
        return 0.0 if c_got <= c_init * (1 + 1e-9) else float("inf")
    return (c_got - c_want) / gain
