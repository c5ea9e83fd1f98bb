"""Distributed bundle adjustment: map-block partitioned Schur-GN (port of
se2lam_tpu/parallel/dist_ba.py).

The map-point axis is partitioned into blocks, one per mesh block, and the
LM loop drives every block (``mesh.py``):

- each block owns M/n points and the observations of those points; its
  (K, M/n) pose–point coupling lives only on its device;
- point elimination is local: on a CUDA block the Schur reduction is
  kernel K3 (``solver/schur.py``) at (K, ⌈M/n⌉), one launch per block per
  LM step;
- the reduced camera systems meet in ONE ``psum`` of (S_p, b_p, the pose
  diagonal, chi2) per step; the odometry edges and the (3K, 3K) solve are
  replicated work, done once on the first block's device;
- back-substitution is local again.

``_make_dist_pcg_solver``'s counterpart (``_pcg_solve``) is matrix-free:
per-point 3×3 blocks reduce locally, and the reduced system is solved by
preconditioned CG (the odometry chain's block-tridiagonal system as the
preconditioner, ``ops/linalg``) with one (K, 3) ``psum`` per CG step; it
never calls K3.

Sharded fields of a ``DistBAProblem`` are lists with one tensor per block
(``gather`` gives the JAX package's concatenated layout); the rest is one
replicated tensor.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import factors
from ..ops import fixed_order, linalg, se2
from ..ops.camera import CameraModel
from ..solver import ba as ba_mod
from ..solver.ba import BAConfig, BAProblem
from .mesh import Mesh, gather

__all__ = [
    "DistBAProblem", "partition_points", "dist_solve_local_ba",
    "sharded_solve_local_ba", "sharded_solve_joint_ba",
]

_SHARDED = ("points", "point_valid", "obs_kf", "obs_mp", "obs_uv", "obs_info", "obs_valid")


class DistBAProblem(NamedTuple):
    """A BAProblem re-bucketed for map-block distribution. ``points`` and
    ``point_valid`` are lists of n (Mb, …) blocks, block b owning global
    rows [b·Mb, (b+1)·Mb); the ``obs_*`` fields lists of n (obs_cap, …)
    blocks whose point indices are LOCAL to the block. Everything else is
    replicated."""

    poses: torch.Tensor        # (K, 3)
    pose_valid: torch.Tensor   # (K,)
    pose_fixed: torch.Tensor   # (K,)
    points: list               # n × (Mb, 3)
    point_valid: list          # n × (Mb,)
    obs_kf: list               # n × (Ob,) global KF index
    obs_mp: list               # n × (Ob,) block-local point index
    obs_uv: list               # n × (Ob, 2)
    obs_info: list             # n × (Ob, 2, 2)
    obs_valid: list            # n × (Ob,)
    edge_i: torch.Tensor       # (E,) replicated odometry edges
    edge_j: torch.Tensor
    edge_meas: torch.Tensor
    edge_info: torch.Tensor
    edge_valid: torch.Tensor
    n_obs_dropped: torch.Tensor  # () int32: overflow past the per-block capacity

    def gathered(self) -> dict:
        """The sharded fields in the JAX package's concatenated layout."""
        return {k: gather(getattr(self, k)) for k in _SHARDED}


def partition_points(prob: BAProblem, n: int, obs_cap: int, grid: bool = False,
                     mesh: Mesh | None = None) -> DistBAProblem:
    """Bucket a BAProblem into ``n`` point blocks with ≤ ``obs_cap``
    observations each, bitwise the JAX package's partition: points padded
    to a multiple of n, observations stably sorted by owning block and
    scattered into fixed-capacity slots (overflow dropped and counted in
    ``n_obs_dropped``).

    ``grid``: the observation axis is the M×P grid (o = m·P + p); rows
    are bucketed by ``obs_mp`` whatever their validity, which keeps each
    block's (Mb, P) grid. Needs M divisible by n and obs_cap = (M/n)·P.

    ``mesh``: put block b on ``mesh``'s device for it (all n blocks must
    be local); without it the blocks stay on the problem's device."""
    dev = prob.points.device
    M, O = prob.points.shape[0], prob.obs_kf.shape[0]
    Mb = -(-M // n)
    pad_m = Mb * n - M
    points = torch.nn.functional.pad(prob.points, (0, 0, 0, pad_m))
    point_valid = torch.nn.functional.pad(prob.point_valid, (0, pad_m))
    if grid:
        assert pad_m == 0, "grid partition requires M divisible by n"
        assert obs_cap == Mb * (O // M), (obs_cap, Mb, O // M)
    obs_mp = prob.obs_mp.long()
    bid = obs_mp // Mb if grid else torch.where(prob.obs_valid, obs_mp // Mb, n)
    order = torch.argsort(bid, stable=True)
    counts = torch.bincount(bid, minlength=n + 1)[: n + 1]
    starts = torch.cumsum(counts, 0) - counts
    bid_s = bid[order]
    rank = torch.arange(O, device=dev) - starts[bid_s]
    ok = (bid_s < n) & (rank < obs_cap)
    row = torch.where(ok, bid_s, n)
    col = torch.where(ok, rank, 0)

    def scat(x, fill):
        out = torch.full((n + 1, obs_cap) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev)
        # several dropped rows share (n, 0); that row is cut off below
        out[row, col] = x[order]
        return list(out[:n].unbind(0))

    obs_local = (obs_mp % Mb).to(torch.int32)
    dropped = (counts[:n].sum() - ok.sum()).to(torch.int32)

    def place(blocks):
        if mesh is None:
            return blocks
        return mesh.local(blocks)

    return DistBAProblem(
        poses=prob.poses, pose_valid=prob.pose_valid, pose_fixed=prob.pose_fixed,
        points=place(list(points.chunk(n))), point_valid=place(list(point_valid.chunk(n))),
        obs_kf=place(scat(prob.obs_kf, 0)), obs_mp=place(scat(obs_local, 0)),
        obs_uv=place(scat(prob.obs_uv, 0.0)), obs_info=place(scat(prob.obs_info, 0.0)),
        obs_valid=place(scat(prob.obs_valid, False)),
        edge_i=prob.edge_i, edge_j=prob.edge_j, edge_meas=prob.edge_meas,
        edge_info=prob.edge_info, edge_valid=prob.edge_valid, n_obs_dropped=dropped,
    )


class _Block(NamedTuple):
    """One block's observation shard and constants, on its device."""

    obs_kf: torch.Tensor
    obs_mp: torch.Tensor
    obs_uv: torch.Tensor
    obs_info: torch.Tensor
    obs_valid: torch.Tensor
    point_valid: torch.Tensor
    cam: CameraModel
    Tcb: torch.Tensor


def _blocks(dp: DistBAProblem, cam: CameraModel, Tcb, mesh: Mesh):
    """The problem's local blocks on their devices (``partition_points``
    without a mesh leaves them on one device)."""
    out = []
    n_local = len(mesh.devices)
    if len(dp.obs_kf) == mesh.size and mesh.size != n_local:
        local = {k: mesh.local(getattr(dp, k)) for k in _SHARDED}
    else:
        local = {k: [b.to(d) for b, d in zip(getattr(dp, k), mesh.devices)] for k in _SHARDED}
    if len(local["obs_kf"]) != n_local:
        raise ValueError(f"a problem of {len(dp.obs_kf)} blocks on a mesh of {mesh.size}")
    for b, d in enumerate(mesh.devices):
        out.append(_Block(
            obs_kf=local["obs_kf"][b].long(), obs_mp=local["obs_mp"][b].clamp(min=0).long(),
            obs_uv=local["obs_uv"][b], obs_info=local["obs_info"][b],
            obs_valid=local["obs_valid"][b], point_valid=local["point_valid"][b],
            cam=CameraModel(*(t.to(d) for t in cam)), Tcb=Tcb.to(d)))
    return out, local["points"]


def _dp_obs_terms(blk: _Block, poses, points, huber_delta):
    """Per-observation residual, Jacobians and weight blocks of one block
    (shared by both solvers; ``dist_ba.py:155``)."""
    p = poses[blk.obs_kf]
    x = points[blk.obs_mp]
    r, Jp, Jx = factors.se2xyz_residual_jac(p, x, blk.obs_uv, blk.cam, blk.Tcb)
    chi2 = torch.einsum("oi,oij,oj->o", r, blk.obs_info, r)
    sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    w_h = torch.where(sqrt_chi > huber_delta, huber_delta / sqrt_chi, torch.ones_like(sqrt_chi))
    # zero weight at/behind the camera at the CURRENT state
    z_ok = factors.se2xyz_depth(p, x, blk.Tcb) > 1e-3
    W = blk.obs_info * torch.where(blk.obs_valid & z_ok, w_h,
                                   torch.zeros_like(w_h))[:, None, None]
    return r, Jp, Jx, W, chi2, z_ok


def _dp_edge_terms(dp: DistBAProblem, poses):
    """The replicated odometry edges' residuals, Jacobians and weights."""
    r, Ji, Jj = factors.pre_se2_residual_jac(
        poses[dp.edge_i.long()], poses[dp.edge_j.long()], dp.edge_meas)
    W = torch.where(dp.edge_valid[:, None, None], dp.edge_info, torch.zeros_like(dp.edge_info))
    chi2 = torch.einsum("ei,eij,ej->e", r, dp.edge_info, r)
    return r, Ji, Jj, W, chi2


def _dp_robust_cost(dp, blocks, mesh, huber_delta, poses_b, points_b):
    """``ba_chi2``'s counterpart: the psum of the blocks' Huber rho (at/
    behind-camera observations pinned at the cap) plus the replicated
    edges' chi2, on the first block's device."""
    parts = []
    for blk, pb, xb in zip(blocks, poses_b, points_b):
        _, _, _, _, chi_o, z_ok = _dp_obs_terms(blk, pb, xb, math.inf)
        cap = torch.full_like(chi_o, ba_mod._CHI2_CAP)
        chi_c = torch.where(z_ok, torch.minimum(chi_o, cap), cap)
        rho = factors.huber_rho(chi_c, huber_delta)
        parts.append(torch.where(blk.obs_valid, rho, torch.zeros_like(rho)).sum())
    c_obs = mesh.psum(parts)[0]
    _, _, _, _, chi_e = _dp_edge_terms(dp, poses_b[0])
    return c_obs + torch.where(dp.edge_valid, chi_e, torch.zeros_like(chi_e)).sum()


def _lm(dp, blocks, points, mesh, cfg, solve_inner):
    """The LM loop both solvers share: ``cfg.iters`` steps, each accepted
    on the robust cost with ``torch.where``, nothing read to the host.
    Returns (poses (K, 3), local point blocks, info)."""
    d0 = mesh.devices[0]
    poses = dp.poses.to(d0)
    lam = torch.tensor(cfg.lm_init_lambda, dtype=poses.dtype, device=d0)
    chi0 = _dp_robust_cost(dp, blocks, mesh, cfg.huber_delta, mesh.replicate(poses), points)
    last = chi0
    for _ in range(cfg.iters):
        dpose, dx = solve_inner(poses, points, lam)
        new_poses = poses + dpose
        new_poses = torch.cat([new_poses[:, :2], se2.normalize_angle(new_poses[:, 2:3])], 1)
        new_points = [x + d for x, d in zip(points, dx)]
        new_chi = _dp_robust_cost(dp, blocks, mesh, cfg.huber_delta,
                                  mesh.replicate(new_poses), new_points)
        # accept on the robust objective carried across iterations
        accept = new_chi < last
        acc_b = mesh.replicate(accept)
        poses = torch.where(accept, new_poses, poses)
        points = [torch.where(a, nx, x) for a, nx, x in zip(acc_b, new_points, points)]
        lam = torch.where(accept, lam * cfg.lm_down, lam * cfg.lm_up)
        last = torch.where(accept, new_chi, last)
    info = {"chi2": last, "chi2_init": chi0, "lambda": lam,
            "n_obs_dropped": dp.n_obs_dropped}
    return poses, points, info


def _edge_blocks(dp, poses):
    """The edges' weighted blocks JᵢᵀW, JⱼᵀW and their Jacobians."""
    r_e, Ji, Jj, We, chi_e = _dp_edge_terms(dp, poses)
    JiW = torch.einsum("eab,eac->ebc", Ji, We)
    JjW = torch.einsum("eab,eac->ebc", Jj, We)
    return r_e, Ji, Jj, We, chi_e, JiW, JjW


def dist_solve_local_ba(dprob: DistBAProblem, cam: CameraModel, Tcb, cfg: BAConfig,
                        mesh: Mesh, axis: str = "d"):
    """Solve a partitioned problem on the mesh with the dense reduced
    system (``dist_ba.py:214``). Returns (poses (K, 3) on the first block's
    device, the local point blocks, info)."""
    blocks, points = _blocks(dprob, cam, Tcb, mesh)
    d0 = mesh.devices[0]
    dp = dprob._replace(**{k: getattr(dprob, k).to(d0) for k in (
        "pose_valid", "pose_fixed", "edge_i", "edge_j", "edge_meas", "edge_info", "edge_valid")})
    K = dp.poses.shape[0]
    dtype = dp.poses.dtype
    eye3 = torch.eye(3, dtype=dtype, device=d0)
    free3 = (dp.pose_valid & ~dp.pose_fixed).to(dtype).repeat_interleave(3)
    diag = torch.arange(K, device=d0)
    ei, ej = dp.edge_i.long(), dp.edge_j.long()

    def solve_inner(poses, points_b, lam):
        poses_b, lam_b = mesh.replicate(poses), mesh.replicate(lam)
        parts, local = [], []
        for blk, pb, xb, lb in zip(blocks, poses_b, points_b, lam_b):
            Mb = xb.shape[0]
            r_o, Jp, Jx, W, chi_o, _ = _dp_obs_terms(blk, pb, xb, cfg.huber_delta)
            JpW = torch.einsum("oab,oac->obc", Jp, W)
            JxW = torch.einsum("oab,oac->obc", Jx, W)
            Hpp_p, bp_p, Hxx, bx, Hpx = ba_mod.accumulate_obs(
                K, Mb, blk.obs_kf, blk.obs_mp, JpW @ Jp, JxW @ Jx, JpW @ Jx,
                -torch.einsum("oab,ob->oa", JpW, r_o), -torch.einsum("oab,ob->oa", JxW, r_o))
            # Marquardt damping with block-relative floors, the
            # single-device solver's verbatim (point blocks are local)
            e3 = torch.eye(3, dtype=dtype, device=xb.device)
            Hxx = Hxx + lb * ba_mod._floored_diag(Hxx)[..., None] * e3[None]
            Hxx_safe = torch.where(blk.point_valid[:, None, None], Hxx + cfg.eps * e3[None],
                                   e3[None].expand_as(Hxx))
            Hxx_inv = linalg.inv3x3(Hxx_safe)
            # the block's point elimination: K3 on a CUDA block
            S_p, b_p = ba_mod.schur_reduce(Hpp_p, bp_p, Hpx, Hxx_inv, bx)
            kd = torch.arange(K, device=xb.device)
            dpp_p = torch.diagonal(Hpp_p[kd, kd], dim1=-2, dim2=-1)
            chi = torch.where(blk.obs_valid, chi_o, torch.zeros_like(chi_o)).sum()
            parts.append((S_p, b_p, dpp_p, chi))
            local.append((Hpx, Hxx_inv, bx))
        # the ONE collective of the step
        S, b_red, dpp, _chi = mesh.psum(parts)[0]

        # the odometry edges, replicated work after the reduction
        r_e, Ji, Jj, We, _chi_e, JiW, JjW = _edge_blocks(dp, poses)
        S = S.clone()
        S.index_put_((ei, ei), JiW @ Ji, accumulate=True)
        S.index_put_((ei, ej), JiW @ Jj, accumulate=True)
        S.index_put_((ej, ei), JjW @ Ji, accumulate=True)
        S.index_put_((ej, ej), JjW @ Jj, accumulate=True)
        b_red = fixed_order.index_add(b_red, ei, -torch.einsum("eab,eb->ea", JiW, r_e))
        b_red = fixed_order.index_add(b_red, ej, -torch.einsum("eab,eb->ea", JjW, r_e))
        # Marquardt on the total pose diagonal (observations + edges)
        dpp = fixed_order.index_add(dpp, ei, torch.diagonal(JiW @ Ji, dim1=-2, dim2=-1))
        dpp = fixed_order.index_add(dpp, ej, torch.diagonal(JjW @ Jj, dim1=-2, dim2=-1))
        dpp = torch.maximum(dpp, 1e-3 * dpp.amax(dim=-1, keepdim=True) + 1e-6)
        S[diag, diag] += lam * dpp[..., None] * eye3[None]
        S_d = S.permute(0, 2, 1, 3).reshape(3 * K, 3 * K)
        S_d, b_d = ba_mod._fix_gauge(S_d, b_red.reshape(3 * K), free3)
        dpose = torch.linalg.solve(S_d + cfg.eps * torch.eye(3 * K, dtype=dtype, device=d0), b_d)
        dpose = (dpose * free3).reshape(K, 3)

        # local back-substitution for each owned point block
        dx = []
        for (Hpx, Hxx_inv, bx), blk, dpb in zip(local, blocks, mesh.replicate(dpose)):
            rhs_x = bx - torch.einsum("kamb,ka->mb", Hpx, dpb)
            d = torch.einsum("mab,mb->ma", Hxx_inv, rhs_x)
            dx.append(torch.where(blk.point_valid[:, None], d, torch.zeros_like(d)))
        return dpose, dx

    return _lm(dp, blocks, points, mesh, cfg, solve_inner)


def _pcg_solve(dprob: DistBAProblem, cam, Tcb, cfg: BAConfig, mesh: Mesh, cg_iters: int,
               grid_p: int, precond: str):
    """Matrix-free distributed Schur-GN (``dist_ba.py:400``): Marquardt
    (λ·diag) damping; per LM step the point blocks reduce locally and the
    reduced camera system S·v = (Hpp + λ)·v − Hpx·Hxx⁻¹·Hpxᵀ·v is solved by
    ``cg_iters`` steps of preconditioned CG, one (K, 3) psum each."""
    blocks, points = _blocks(dprob, cam, Tcb, mesh)
    d0 = mesh.devices[0]
    dp = dprob._replace(**{k: getattr(dprob, k).to(d0) for k in (
        "pose_valid", "pose_fixed", "edge_i", "edge_j", "edge_meas", "edge_info", "edge_valid")})
    K = dp.poses.shape[0]
    dtype = dp.poses.dtype
    eye3 = torch.eye(3, dtype=dtype, device=d0)
    free = dp.pose_valid & ~dp.pose_fixed
    fm = free.to(dtype)[:, None]
    ei, ej = dp.edge_i.long(), dp.edge_j.long()

    def point_reduce(contrib, blk, Mb):
        """(O, …) → (Mb, …): a reshape-sum on the grid, else a scatter-add."""
        if grid_p > 0:
            return contrib.reshape((Mb, grid_p) + tuple(contrib.shape[1:])).sum(1)
        out = torch.zeros((Mb,) + tuple(contrib.shape[1:]), dtype=dtype, device=contrib.device)
        return fixed_order.index_add(out, blk.obs_mp, contrib)

    def kf_reduce(contribs):
        """The blocks' (O, …) contributions → replicated (K, …): a local
        scatter each, then one psum."""
        parts = [fixed_order.index_add(
            torch.zeros((K,) + tuple(c.shape[1:]), dtype=dtype, device=c.device), blk.obs_kf, c)
            for c, blk in zip(contribs, blocks)]
        return mesh.psum(parts)[0]

    def solve_inner(poses, points_b, lam):
        poses_b, lam_b = mesh.replicate(poses), mesh.replicate(lam)
        st = []
        for blk, pb, xb, lb in zip(blocks, poses_b, points_b, lam_b):
            Mb = xb.shape[0]
            r_o, Jp, Jx, W, chi_o, _ = _dp_obs_terms(blk, pb, xb, cfg.huber_delta)
            JpW = torch.einsum("oab,oac->obc", Jp, W)
            JxW = torch.einsum("oab,oac->obc", Jx, W)
            e3 = torch.eye(3, dtype=dtype, device=xb.device)
            Hxx_raw = point_reduce(JxW @ Jx, blk, Mb)
            Hxx = Hxx_raw + lb * torch.diag_embed(torch.diagonal(Hxx_raw, dim1=-2, dim2=-1))
            Hxx_safe = torch.where(blk.point_valid[:, None, None], Hxx + cfg.eps * e3[None],
                                   e3[None].expand_as(Hxx))
            st.append(dict(r=r_o, Jp=Jp, Jx=Jx, W=W, JpW=JpW, chi=chi_o, Mb=Mb,
                           Hxx_inv=linalg.inv3x3(Hxx_safe),
                           bx=point_reduce(-torch.einsum("oab,ob->oa", JxW, r_o), blk, Mb)))
        bp = kf_reduce([-torch.einsum("oab,ob->oa", s["JpW"], s["r"]) for s in st])
        D_obs = kf_reduce([s["JpW"] @ s["Jp"] for s in st])

        r_e, Ji, Jj, We, _chi_e, JiW, JjW = _edge_blocks(dp, poses)
        bp = fixed_order.index_add(bp, ei, -torch.einsum("eab,eb->ea", JiW, r_e))
        bp = fixed_order.index_add(bp, ej, -torch.einsum("eab,eb->ea", JjW, r_e))
        # the chain-aware block-tridiagonal preconditioner: diagonal from
        # every term and the damping, sub-diagonal from consecutive-pose
        # edges (loop edges only on the diagonal)
        D = fixed_order.index_add(fixed_order.index_add(D_obs, ei, JiW @ Ji), ej, JjW @ Jj)
        damp = lam * torch.diagonal(D, dim1=-2, dim2=-1) + cfg.eps
        chain = dp.edge_valid & (ej == ei + 1)
        free_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=d0), free[:-1]])
        Lrow = torch.where(chain, ej, K)
        Lblk = torch.zeros((K + 1, 3, 3), dtype=dtype, device=d0)
        Lblk[Lrow] = JjW @ Ji          # a chain's rows are distinct; row K is dropped
        Lblk = torch.where((free & free_prev)[:, None, None], Lblk[:K], torch.zeros_like(Lblk[:K]))
        D_pc = torch.where(free[:, None, None], D + torch.diag_embed(damp), eye3[None])
        if precond == "jacobi":
            Lblk = torch.zeros_like(Lblk)
        Cinv, _ = linalg.block_tridiag_factor(D_pc, Lblk)

        def HpxT_v(v_b):
            """(K, 3) replicated → the blocks' (Mb, 3): Hpxᵀ·v by sweeps."""
            out = []
            for s, blk, v in zip(st, blocks, v_b):
                t = torch.einsum("oab,ob->oa", s["Jp"], v[blk.obs_kf])
                Wt = torch.einsum("oab,ob->oa", s["W"], t)
                out.append(point_reduce(torch.einsum("oba,ob->oa", s["Jx"], Wt), blk, s["Mb"]))
            return out

        def Hpx_y(y_b):
            """The blocks' (Mb, 3) → replicated (K, 3): Hpx·y (one psum)."""
            contribs = []
            for s, blk, y in zip(st, blocks, y_b):
                t = torch.einsum("oab,ob->oa", s["Jx"], y[blk.obs_mp])
                Wt = torch.einsum("oab,ob->oa", s["W"], t)
                contribs.append(torch.einsum("oba,ob->oa", s["Jp"], Wt))
            return kf_reduce(contribs)

        def Hxxinv_apply(y_b):
            return [torch.einsum("mab,mb->ma", s["Hxx_inv"], y) for s, y in zip(st, y_b)]

        def Sv(v):
            v = v * fm
            out = torch.einsum("kab,kb->ka", D_obs, v)
            te = (torch.einsum("eab,eb->ea", Ji, v[ei]) + torch.einsum("eab,eb->ea", Jj, v[ej]))
            Wte = torch.einsum("eab,eb->ea", We, te)
            out = fixed_order.index_add(out, ei, torch.einsum("eba,eb->ea", Ji, Wte))
            out = fixed_order.index_add(out, ej, torch.einsum("eba,eb->ea", Jj, Wte))
            out = out - Hpx_y(Hxxinv_apply(HpxT_v(mesh.replicate(v))))
            return (out + damp * v) * fm

        def apply_precond(v):
            if precond == "none":
                return v * fm
            return linalg.block_tridiag_solve(Cinv, Lblk, v * fm) * fm

        b_red = (bp - Hpx_y(Hxxinv_apply([s["bx"] for s in st]))) * fm
        x = torch.zeros((K, 3), dtype=dtype, device=d0)
        rr, zz = b_red, apply_precond(b_red)
        pp, rz = zz, (b_red * zz).sum()
        zero = torch.zeros((), dtype=dtype, device=d0)
        for _ in range(cg_iters):
            Ap = Sv(pp)
            pAp = (pp * Ap).sum()
            alpha = torch.where(pAp > 1e-30, rz / pAp, zero)
            x = x + alpha * pp
            rr = rr - alpha * Ap
            zz = apply_precond(rr)
            rz_new = (rr * zz).sum()
            beta = torch.where(rz > 1e-30, rz_new / rz, zero)
            pp = zz + beta * pp
            rz = rz_new
        dpose = x * fm

        rhs = [s["bx"] - h for s, h in zip(st, HpxT_v(mesh.replicate(dpose)))]
        dx = [torch.where(blk.point_valid[:, None], d, torch.zeros_like(d))
              for blk, d in zip(blocks, Hxxinv_apply(rhs))]
        return dpose, dx

    return _lm(dp, blocks, points, mesh, cfg, solve_inner)


def _default_obs_cap(O: int, n: int) -> int:
    return max(1, math.ceil(O / n) * 2)


def _reassemble(mesh: Mesh, points_b, M: int):
    """The solved point blocks, every process's, in the concatenated
    layout on the first block's device, cut to the problem's M rows."""
    return gather(mesh.all_blocks(points_b), mesh.devices[0])[:M]


def sharded_solve_local_ba(prob: BAProblem, cam: CameraModel, Tcb, cfg: BAConfig, mesh: Mesh,
                           axis: str = "d", obs_cap: int | None = None):
    """Partition, solve, reassemble: the distributed counterpart of
    ``solver.ba.solve_local_ba`` (``dist_ba.py:697``). ``obs_cap`` bounds
    a block's observations (default 2·O/n; overflow is dropped and
    reported in ``info["n_obs_dropped"]``). Returns (poses (K, 3), points
    (M, 3), info), on the mesh's first device."""
    n = mesh.shape[axis]
    M, O = prob.points.shape[0], prob.obs_kf.shape[0]
    dprob = partition_points(prob, n, obs_cap or _default_obs_cap(O, n))
    poses, points_b, info = dist_solve_local_ba(dprob, cam, Tcb, cfg, mesh, axis)
    return poses, _reassemble(mesh, points_b, M), info


def sharded_solve_joint_ba(prob: BAProblem, cam: CameraModel, Tcb, cfg: BAConfig, mesh: Mesh,
                           axis: str = "d", cg_iters: int = 64, grid_p: int = 0,
                           obs_cap: int | None = None, precond: str = "tridiag"):
    """Partition, matrix-free PCG solve, reassemble (``dist_ba.py:659``):
    the bank-scale counterpart of ``sharded_solve_local_ba``. ``grid_p``:
    the observation grid period P when ``prob`` enumerates observations
    as the M×P grid (point-side sums are then reshapes). ``precond``:
    "tridiag", "jacobi" or "none". Returns (poses, points (M, 3), info)."""
    n = mesh.shape[axis]
    M, O = prob.points.shape[0], prob.obs_kf.shape[0]
    if grid_p > 0:
        assert M % n == 0 and O == M * grid_p, (M, n, O, grid_p)
        dprob = partition_points(prob, n, (M // n) * grid_p, grid=True)
    else:
        dprob = partition_points(prob, n, obs_cap or _default_obs_cap(O, n))
    poses, points_b, info = _pcg_solve(dprob, cam, Tcb, cfg, mesh, cg_iters, grid_p, precond)
    return poses, _reassemble(mesh, points_b, M), info
