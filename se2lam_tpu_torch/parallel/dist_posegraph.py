"""Distributed SE(2) pose-graph solver: edge-sharded matrix-free PCG (port
of se2lam_tpu/parallel/dist_posegraph.py).

The single-device solver (``solver/posegraph.py``) assembles the dense
(3K, 3K) Hessian. Here the EDGES are split over the mesh's blocks and each
Gauss-Newton system is solved by preconditioned conjugate gradients whose
operator H·v is a gather, 3x3 products and a scatter-add over each block's
edges plus ONE (K, 3) ``psum``; the Hessian is never formed. The
preconditioner is the odometry chain's block-tridiagonal system, solved
exactly per application (``ops/linalg.block_tridiag_*``; psum'd diagonal
and chain blocks), or the block-Jacobi diagonal (``precond="jacobi"``).
Poses (K·3 floats) and the CG vectors are replicated, kept on the first
block's device. Levenberg damping, Huber weights and accept/reject mirror
the dense solver.
"""
from __future__ import annotations

import math

import torch

from .. import factors
from ..ops import fixed_order, linalg, se2
from ..solver.posegraph import PoseGraphProblem
from .mesh import Mesh

__all__ = ["dist_solve_pose_graph"]

_EDGES = ("edge_i", "edge_j", "edge_meas", "edge_info", "edge_valid")


def _pad_edges(prob: PoseGraphProblem, n: int) -> PoseGraphProblem:
    """Edges padded with invalid zero rows to a multiple of ``n``."""
    pad = (-prob.edge_i.shape[0]) % n
    if pad == 0:
        return prob

    def p(x):
        return torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                         device=x.device)])
    return prob._replace(**{k: p(getattr(prob, k)) for k in _EDGES})


def dist_solve_pose_graph(prob: PoseGraphProblem, mesh: Mesh, iters: int = 15,
                          cg_iters: int = 64, huber_delta: float = math.inf,
                          lm_init_lambda: float = 1e-6, axis: str = "d",
                          precond: str = "tridiag"):
    """Solve the pose graph with its edges split over ``mesh``. Returns
    (poses (K, 3), {"chi2", "chi2_init"}) on the mesh's first device.
    ``cg_iters`` bounds the inner PCG; ``precond`` is "tridiag" (the
    chain solved exactly, removing the cg_iters ≈ K wall of chain-dominated
    graphs) or "jacobi"."""
    n = mesh.shape[axis]
    d0 = mesh.devices[0]
    prob = _pad_edges(prob, n)
    edges = {k: mesh.local(list(getattr(prob, k).chunk(n))) for k in _EDGES}
    blocks = [dict(zip(_EDGES, vals)) for vals in zip(*(edges[k] for k in _EDGES))]
    for e in blocks:
        e["ei"], e["ej"] = e["edge_i"].long(), e["edge_j"].long()
    K = prob.poses.shape[0]
    dtype = prob.poses.dtype
    free = (prob.pose_valid & ~prob.pose_fixed).to(d0)
    fm = free.to(dtype)[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=d0)

    def edge_terms(e, p, delta):
        r, Ji, Jj = factors.pre_se2_residual_jac(p[e["ei"]], p[e["ej"]], e["edge_meas"])
        chi2 = torch.einsum("ei,eij,ej->e", r, e["edge_info"], r)
        sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(sqrt_chi > delta, delta / sqrt_chi, torch.ones_like(sqrt_chi))
        W = e["edge_info"] * torch.where(e["edge_valid"], w, torch.zeros_like(w))[:, None, None]
        return r, Ji, Jj, W, chi2

    def robust_cost(p):
        parts = []
        for e, pb in zip(blocks, mesh.replicate(p)):
            chi2 = edge_terms(e, pb, math.inf)[4]
            rho = factors.huber_rho(chi2, huber_delta)
            parts.append(torch.where(e["edge_valid"], rho, torch.zeros_like(rho)).sum())
        return mesh.psum(parts)[0]

    def scatter_k(idx, vals, shape):
        return fixed_order.index_add(torch.zeros((K,) + shape, dtype=dtype, device=vals.device),
                                     idx, vals)

    p = prob.poses.to(d0)
    lam = torch.tensor(lm_init_lambda, dtype=dtype, device=d0)
    chi0 = robust_cost(p)
    last = chi0
    zero = torch.zeros((), dtype=dtype, device=d0)
    for _ in range(iters):
        st, b_parts, D_parts, L_parts = [], [], [], []
        for e, pb in zip(blocks, mesh.replicate(p)):
            r, Ji, Jj, W, _ = edge_terms(e, pb, huber_delta)
            JiW = torch.einsum("eab,eac->ebc", Ji, W)
            JjW = torch.einsum("eab,eac->ebc", Jj, W)
            st.append((Ji, Jj, W))
            b_parts.append(scatter_k(e["ei"], -torch.einsum("eab,eb->ea", JiW, r), (3,))
                           + scatter_k(e["ej"], -torch.einsum("eab,eb->ea", JjW, r), (3,)))
            D_parts.append(fixed_order.index_add(scatter_k(e["ei"], JiW @ Ji, (3, 3)),
                                                 e["ej"], JjW @ Jj))
            if precond == "tridiag":
                chain = e["edge_valid"] & (e["ej"] == e["ei"] + 1)
                Lrow = torch.where(chain, e["ej"], K)
                L = torch.zeros((K + 1, 3, 3), dtype=dtype, device=pb.device)
                L_parts.append(fixed_order.index_add(L, Lrow, JjW @ Ji)[:K])
        # the gradient and the preconditioner blocks: one psum each
        b = mesh.psum(b_parts)[0] * fm
        D = mesh.psum(D_parts)[0]
        damp = lam * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-9
        D_pc = torch.where(free[:, None, None], D + torch.diag_embed(damp), eye3[None])
        if precond == "tridiag":
            free_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=d0), free[:-1]])
            Lblk = mesh.psum(L_parts)[0]
            Lblk = torch.where((free & free_prev)[:, None, None], Lblk, torch.zeros_like(Lblk))
            Cinv, _ = linalg.block_tridiag_factor(D_pc, Lblk)

            def precond_apply(v):
                return linalg.block_tridiag_solve(Cinv, Lblk, v * fm) * fm
        else:
            Minv = linalg.inv3x3(D_pc)

            def precond_apply(v):
                return torch.einsum("kab,kb->ka", Minv, v) * fm

        def Hv(v):
            v = v * fm
            parts = []
            for e, (Ji, Jj, W), vb in zip(blocks, st, mesh.replicate(v)):
                t = (torch.einsum("eab,eb->ea", Ji, vb[e["ei"]])
                     + torch.einsum("eab,eb->ea", Jj, vb[e["ej"]]))
                Wt = torch.einsum("eab,eb->ea", W, t)
                parts.append(fixed_order.index_add(
                    scatter_k(e["ei"], torch.einsum("eba,eb->ea", Ji, Wt), (3,)),
                    e["ej"], torch.einsum("eba,eb->ea", Jj, Wt)))
            return (mesh.psum(parts)[0] + damp * v) * fm

        x = torch.zeros((K, 3), dtype=dtype, device=d0)
        rr, zz = b, precond_apply(b)
        pp, rz = zz, (b * zz).sum()
        for _ in range(cg_iters):
            Ap = Hv(pp)
            pAp = (pp * Ap).sum()
            alpha = torch.where(pAp > 1e-30, rz / pAp, zero)
            x = x + alpha * pp
            rr = rr - alpha * Ap
            zz = precond_apply(rr)
            rz_new = (rr * zz).sum()
            beta = torch.where(rz > 1e-30, rz_new / rz, zero)
            pp = zz + beta * pp
            rz = rz_new

        new_p = p + x * fm
        new_p = torch.cat([new_p[:, :2], se2.normalize_angle(new_p[:, 2:3])], 1)
        new_chi2 = robust_cost(new_p)
        accept = new_chi2 < last
        p = torch.where(accept, new_p, p)
        lam = torch.where(accept, lam * 0.5, lam * 10.0)
        last = torch.where(accept, new_chi2, last)
    return p, {"chi2": last, "chi2_init": chi0}
