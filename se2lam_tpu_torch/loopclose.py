"""Loop closing and global mapping (port of se2lam_tpu.loopclose; reference
GlobalMapper thread, src/GlobalMapper.cpp).

On each new keyframe (``LoopCloser.on_new_kf``, the stage ``loop_stage``):
feature-edge partner selection by graph distance, BoW scoring against the
whole keyframe bank (DetectLoopClose, :201-254), descriptor verification
with RANSAC and map-point gates for the partners and the loop candidate
together (VerifyLoopClose, :256-326), a pose-only relative constraint per
verified pair (the Sparsifier's role), map-point fusion
(Map::mergeLoopClose, src/Map.cpp:333-352) and, on a closure or a renewed
feature graph, the pose-graph GlobalBA (:328-535) followed on a closure by
a joint pose+point BA over the whole map, which runs the Schur kernel K3
at bank scale (``solver/ba.py``).

Every function takes and returns a ``MapState``; none writes an input in
place. Keyframe slots may be Python ints or 0-d tensors on the map's
device. The JAX package runs the closure under ``lax.cond``; here
``loop_stage`` reads its gate decisions back to the host once a keyframe
and runs the closure branch only when it fires. RANSAC draws come from a
``torch.Generator`` or, for parity with the JAX package, as Gumbel noise
of shape (candidates, trials, N).

On a device mesh (``LoopCloser(mesh=...)`` with more than one block) the
stage runs staged, as the JAX package's mesh path does
(``start_async``/``advance``, driven to completion by ``on_new_kf``): the
BoW bank is split over the mesh (``parallel/dist_loop``), the pose-graph
GlobalBA is the edge-sharded PCG (``run_global_ba_dist``) and the joint
GBA the map-block partitioned Schur-GN (``run_global_ba_joint_dist``,
kernel K3 on each CUDA block).

``build_loop_constraint_ba`` is the 2-KF mini-BA constraint with its
sparsifier (``solver/sparsifier.py``): no path of the stage calls it, as in
the JAX package, whose default is the metrically anchored
``build_loop_constraint``. Its local BA runs K3 at (K, M) = (2, N).
"""
from __future__ import annotations

import math
import warnings

import torch

from . import factors
from . import vocab as vocab_mod
from .config import SystemConfig
from .device import resolve_device, same_device
from .frontend.matcher import mutual_match
from .frontend.orb import OrbFeatures
from .frontend.ransac import ransac_fundamental
from .localmap import _put_row, _row, _scatter, obs_sigma_info
from .mapstate import MapState, kf_Tcw
from .ops import linalg, se2, se3
from .solver.ba import BAConfig, BAProblem, obs_chi2, solve_local_ba
from .solver.posegraph import PoseGraphProblem, solve_pose_graph
from .solver.poseonly import solve_pose_only
from .solver.sparsifier import marginalize_pair_constraint
from .tracking import constants
from .utils.timing import span

__all__ = [
    "LoopCloser", "kf_features", "verify_loop", "build_loop_constraint_ba",
    "build_loop_constraint",
    "verify_and_build_batch", "select_feat_pairs", "add_ftr_edge", "merge_loop_mps",
    "bow_detect", "build_pose_graph", "apply_pose_graph_result", "run_global_ba",
    "build_global_ba", "run_global_ba_joint", "loop_stage", "run_global_ba_dist",
    "run_global_ba_joint_dist",
]

_I32 = torch.int32

# Huber on the graph edges: accumulated loop/feature constraints carry
# estimation error; robustifying keeps a few bad ones from dragging a
# well-odometered trajectory
POSE_GRAPH_HUBER = 3.0
N_FEAT_CANDS = 4      # select_feat_pairs' max_cands: the stage verifies 4 + 1 pairs


def kf_features(ms: MapState, k) -> OrbFeatures:
    """A stored keyframe's features as an OrbFeatures record; ``k`` may be
    an int or a 0-d tensor on the map's device."""
    N, dev = ms.N, ms.kf_xy.device
    return OrbFeatures(
        xy=_row(ms.kf_xy, k),
        angle=_row(ms.kf_angle, k),
        octave=_row(ms.kf_octave, k),
        response=torch.ones((N,), dtype=ms.kf_xy.dtype, device=dev),
        valid=_row(ms.kf_feat_valid, k),
        desc_bits=torch.zeros((N, 8), dtype=torch.int32, device=dev).view(torch.uint32),
        desc_pm1=_row(ms.kf_desc, k),
    )


def verify_loop(ms: MapState, k, cand, n_trials: int = 128, *,
                generator: torch.Generator | None = None, gumbel=None):
    """Mutual descriptor matching + fundamental RANSAC + map-point pairs
    (VerifyLoopClose, src/GlobalMapper.cpp:256-326). ``gumbel``: the
    RANSAC noise (n_trials, N), instead of drawing from ``generator``.
    Returns (match_idx loop→cur (N,), n_kp, n_mp, n_cur_mp)."""
    f_loop = kf_features(ms, cand)
    f_cur = kf_features(ms, k)
    midx = mutual_match(f_loop, f_cur, nn_ratio=0.9).idx2
    matched = midx >= 0
    cur_xy = f_cur.xy[midx.clamp(min=0).long()]
    fr = ransac_fundamental(f_loop.xy, cur_xy, matched, n_trials=n_trials, thresh_px=3.0,
                            min_inliers=10, generator=generator, gumbel=gumbel)
    # zero-baseline degeneracy: revisiting the mapped viewpoint exactly
    # gives correspondences that determine no fundamental matrix; when the
    # median displacement is tiny the mutual matches stand on their own
    disp = torch.linalg.norm(cur_xy - f_loop.xy, dim=-1)
    disp_sorted = torch.sort(torch.where(matched, disp, torch.full_like(disp, math.inf))).values
    n_matched = matched.sum(dtype=_I32)
    med = disp_sorted[torch.clamp(n_matched // 2, 0, disp.shape[0] - 1).long()]
    near_identical = (med < 2.0) & (n_matched >= 20)
    inliers = torch.where(near_identical, matched, fr.inliers)
    midx = torch.where(inliers, midx, torch.full_like(midx, -1))
    n_kp = torch.where(near_identical, n_matched, fr.n_inliers)

    m_loop = _row(ms.kf_obs_mp, cand)
    m_cur_row = _row(ms.kf_obs_mp, k)
    m_cur = m_cur_row[midx.clamp(min=0).long()]
    mp_pair = ((midx >= 0) & (m_loop >= 0) & (m_cur >= 0)
               & ms.mp_valid[m_loop.clamp(min=0).long()]
               & ms.mp_valid[m_cur.clamp(min=0).long()])
    return midx, n_kp, mp_pair.sum(dtype=_I32), (m_cur_row >= 0).sum(dtype=_I32)


def _loop_pairs(ms: MapState, k, cand, match_idx):
    """The loop keyframe's map points matched into keyframe ``k``: (j,
    pair, points, uv_cur) with j the clamped match indices, ``pair`` the
    matches whose loop-side point is valid, the points' positions and
    their measurements in ``k``."""
    j = match_idx.clamp(min=0).long()
    m_loop = _row(ms.kf_obs_mp, cand)
    ml = m_loop.clamp(min=0).long()
    pair = (match_idx >= 0) & (m_loop >= 0) & ms.mp_valid[ml]
    return j, pair, ms.mp_pos[ml], _row(ms.kf_xy, k)[j]


def _pixel_info(view, info3, cam):
    """Anisotropic 2x2 pixel information from a stored per-view 3x3 point
    information (the mViewMPsInfo role in OptKFPairMatch,
    src/GlobalMapper.cpp:929-1032): Σ_uv = J Σ₃ Jᵀ + I through the camera
    Jacobian at the stored camera-frame point, inverted; identity where
    the information was never filled."""
    dtype, dev = view.dtype, view.device
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    has = torch.diagonal(info3, dim1=-2, dim2=-1).sum(-1) > 1e-9
    sigma3 = linalg.inv3x3(info3 + 1e-9 * torch.eye(3, dtype=dtype, device=dev))
    J = factors.pixel_jacobian(view, cam)
    info2 = linalg.inv2x2(J @ sigma3 @ J.transpose(-1, -2) + eye2)
    return torch.where(has[..., None, None], info2, eye2)


def build_loop_constraint_ba(ms: MapState, k, cand, match_idx, cfg: SystemConfig):
    """2-KF mini-BA + Schur sparsification → one relative SE2 constraint
    (CreateFeatEdge/OptKFPairMatch + Sparsifier,
    src/GlobalMapper.cpp:781-1032, src/sparsifier.cpp:105-274).

    The loop keyframe's pose is fixed; the current pose and the paired
    map points are free (10 LM steps, Huber at √th_huber2; on the card 10
    K3 launches at (2, N)). Pairs with a reprojection chi2 of 25 or more
    in either view after the solve are dropped, and the rest are
    marginalized onto the relative pose. With only two views the
    translation scale is a near-gauge direction that the points' initial
    positions pin through the damping alone; ``build_loop_constraint`` is
    the default for that reason. Returns (meas, info, n_good, good)."""
    c = constants(cfg, ms.kf_pose.device)
    cam, Tcb = c["cam"], c["Tcb"]
    N, dtype, dev = ms.N, ms.kf_pose.dtype, ms.kf_pose.device
    j, pair, points, uv_cur = _loop_pairs(ms, k, cand, match_idx)
    uv_loop = _row(ms.kf_xy, cand)
    info_loop = _pixel_info(_row(ms.kf_view_mp, cand), _row(ms.kf_view_info, cand), cam)
    info_cur = _pixel_info(_row(ms.kf_view_mp, k)[j], _row(ms.kf_view_info, k)[j], cam)

    # the mini-BA: pose_loop fixed, pose_cur and the points free
    one = torch.ones((N,), dtype=_I32, device=dev)
    prob = BAProblem(
        poses=torch.stack([_row(ms.kf_pose, cand), _row(ms.kf_pose, k)]),
        points=points,
        pose_valid=torch.ones((2,), dtype=torch.bool, device=dev),
        pose_fixed=torch.tensor([True, False], device=dev),
        point_valid=pair,
        obs_kf=torch.cat([0 * one, one]),
        obs_mp=torch.arange(N, dtype=_I32, device=dev).repeat(2),
        obs_uv=torch.cat([uv_loop, uv_cur]),
        obs_info=torch.cat([info_loop, info_cur]),
        obs_valid=torch.cat([pair, pair]),
        edge_i=torch.zeros((1,), dtype=_I32, device=dev),
        edge_j=torch.zeros((1,), dtype=_I32, device=dev),
        edge_meas=torch.zeros((1, 3), dtype=dtype, device=dev),
        edge_info=torch.zeros((1, 3, 3), dtype=dtype, device=dev),
        edge_valid=torch.zeros((1,), dtype=torch.bool, device=dev),
    )
    ba_cfg = BAConfig(iters=10, huber_delta=float(cfg.th_huber2) ** 0.5)
    opt_poses, opt_points, _ = solve_local_ba(prob, cam, Tcb, ba_cfg)

    # chi2 gate per pair in both views (OptKFPairMatch chi2 > 5 outliers,
    # src/GlobalMapper.cpp:1006-1022)
    r_cur = factors.se2xyz_residual(opt_poses[1], opt_points, uv_cur, cam, Tcb)
    r_loop = factors.se2xyz_residual(opt_poses[0], opt_points, uv_loop, cam, Tcb)
    good = pair & ((r_cur * r_cur).sum(-1) < 25.0) & ((r_loop * r_loop).sum(-1) < 25.0)
    meas, info = marginalize_pair_constraint(opt_poses[0], opt_poses[1], opt_points, uv_loop,
                                             uv_cur, good, cam, Tcb)
    return meas, info, good.sum(dtype=_I32), good


def build_loop_constraint(ms: MapState, k, cand, match_idx, cfg: SystemConfig):
    """Relative SE2 loop constraint from a pose-only solve of keyframe
    ``k`` against the loop keyframe's FIXED map points (metrically
    anchored, unlike a 2-view free-point mini-BA). The information is the
    pose-only Gauss-Newton Hessian at the optimum over the chi2-gated
    correspondences, transported onto the relative measurement and
    eigenvalue-clamped to [1e-6, gm_loop_info_ceil] (the Sparsifier's
    role, src/sparsifier.cpp:219-274). Returns (meas, info, n_good, good)."""
    c = constants(cfg, ms.kf_pose.device)
    cam, Tcb = c["cam"], c["Tcb"]
    _, pair, points, uv_cur = _loop_pairs(ms, k, cand, match_idx)
    huber = float(cfg.th_huber2) ** 0.5
    pose_opt, _chi, _n = solve_pose_only(_row(ms.kf_pose, k), points, uv_cur, pair, cam, Tcb,
                                         iters=20, huber_delta=huber)
    # chi2 gate per correspondence (OptKFPairMatch chi2>5 outliers,
    # src/GlobalMapper.cpp:1006-1022)
    r, Jp, _ = factors.se2xyz_residual_jac(pose_opt, points, uv_cur, cam, Tcb)
    good = pair & ((r * r).sum(-1) < cfg.th_huber2)
    H = torch.einsum("mai,m,maj->ij", Jp, good.to(Jp.dtype), Jp)
    # transport onto the relative measurement ξ = pose_k ⊖ pose_cand
    pose_loop = _row(ms.kf_pose, cand)
    meas = se2.minus(pose_opt, pose_loop)
    _, _, Jj = factors.pre_se2_residual_jac(pose_loop, pose_opt, meas)
    Jj_inv = torch.linalg.inv_ex(Jj).inverse
    info = Jj_inv.T @ H @ Jj_inv
    info = 0.5 * (info + info.T)
    evals, evecs = torch.linalg.eigh(info)
    evals = torch.clamp(evals, 1e-6, cfg.gm_loop_info_ceil)
    info = (evecs * evals[None, :]) @ evecs.T
    return meas, info, good.sum(dtype=_I32), good


def verify_and_build_batch(ms: MapState, k, cands, cfg: SystemConfig, n_trials: int, *,
                           generator: torch.Generator | None = None, gumbel=None):
    """``verify_loop`` + ``build_loop_constraint`` for each of C candidate
    slots (pre-clipped to the valid range; the caller gates invalid ones).
    ``gumbel``: (C, n_trials, N) RANSAC noise, instead of ``generator``.
    Returns (midx (C,N), n_kp (C,), n_mp (C,), n_cur (C,), meas (C,3),
    info (C,3,3), n_good (C,)). Span ``loop.verify``."""
    with span("loop.verify"):
        outs = []
        for c in range(cands.shape[0]):
            noise = (dict(generator=generator) if gumbel is None else dict(gumbel=gumbel[c]))
            cand = cands[c]
            midx, n_kp, n_mp, n_cur = verify_loop(ms, k, cand, n_trials, **noise)
            meas, info, n_good, _ = build_loop_constraint(ms, k, cand, midx, cfg)
            outs.append((midx, n_kp, n_mp, n_cur, meas, info, n_good))
        return tuple(torch.stack(x) for x in zip(*outs))


def select_feat_pairs(ms: MapState, k, hops: int = 5, max_cands: int = N_FEAT_CANDS):
    """Feature-edge partners by BFS hop distance (Map::SelectKFPairFeat,
    src/Map.cpp:826-854; GetAllConnectedKFs_nLayers,
    src/GlobalMapper.cpp:1310-1335): keyframes covisible with ``k`` but
    more than ``hops`` hops away in the odometry + feature edge graph,
    greedy in id order, each selected keyframe joining the reach of later
    rounds. Returns (max_cands,) int32 slots, -1-padded."""
    K = ms.K
    dev = ms.kf_pose.device
    rows = torch.arange(K, device=dev)
    nxt = ms.kf_pre_next
    has_nxt = nxt >= 0
    nc = nxt.clamp(min=0).long()
    adj = torch.zeros((K, K), dtype=torch.bool, device=dev)
    adj[rows, nc] = adj[rows, nc] | has_nxt
    adj[nc, rows] = adj[nc, rows] | has_nxt
    fi = torch.where(ms.ftr_valid, ms.ftr_i, K)
    fj = torch.where(ms.ftr_valid, ms.ftr_j, 0).clamp(0, K - 1)
    adj = _scatter(adj, (fi, fj), True)
    adj = adj | adj.T

    ids_desc = torch.arange(K, 0, -1, device=dev)
    no_kf = torch.zeros((K,), dtype=torch.bool, device=dev)
    covis_k = _row(ms.covis, k) & ms.kf_valid & (rows != torch.as_tensor(k, device=dev))
    v = _put_row(no_kf, k, True)
    out, sel = [], no_kf
    for _ in range(max_cands):
        reach = (adj & v[None, :]).any(1) | sel
        for _ in range(hops - 1):
            reach = reach | (adj & reach[None, :]).any(1)
        cand_mask = covis_k & ~reach & ~sel
        any_c = cand_mask.any()
        cand = torch.argmax(torch.where(cand_mask, ids_desc, 0))   # lowest-id candidate
        out.append(torch.where(any_c, cand, -1))
        sel = _scatter(sel, torch.where(any_c, cand, K), True)
    return torch.stack(out).to(_I32)


def add_ftr_edge(ms: MapState, i, j, meas, info, evict_if_full: bool = False, active=True):
    """Record a sparsified feature/loop constraint in the first free slot
    (KeyFrame::addFtrMeasureFrom, include/se2lam/KeyFrame.h:101-108). A
    full bank drops the edge, or with ``evict_if_full`` (verified loop
    closures) replaces its lowest-information edge. ``active`` may be a
    bool tensor: False makes the write a no-op."""
    F = ms.ftr_valid.shape[0]
    dev = ms.ftr_valid.device
    slot = torch.argmin(ms.ftr_valid.to(_I32))          # first free slot
    full = ms.ftr_valid[slot]
    if evict_if_full:
        weakest = torch.argmin(torch.diagonal(ms.ftr_info, dim1=-2, dim2=-1).sum(-1))
        slot = torch.where(full, weakest, slot)
    else:
        slot = torch.where(full, F, slot)
    slot = torch.where(torch.as_tensor(active, device=dev), slot, F).reshape(1)

    def put(x, v):
        return _scatter(x, slot, torch.as_tensor(v, dtype=x.dtype, device=dev)[None])

    return ms._replace(
        ftr_i=put(ms.ftr_i, i), ftr_j=put(ms.ftr_j, j), ftr_meas=put(ms.ftr_meas, meas),
        ftr_info=put(ms.ftr_info, info), ftr_valid=put(ms.ftr_valid, True),
    )


def _scatter_max(x, idx, vals):
    """``x.at[idx].max(vals, mode="drop")`` for indices in [0, len(x)]."""
    ext = torch.cat([x, x[:1]]).to(_I32)
    ext.scatter_reduce_(0, idx.long(), vals.to(_I32), reduce="amax", include_self=True)
    return ext[: x.shape[0]].to(x.dtype)


def merge_loop_mps(ms: MapState, k, cand, match_idx):
    """Fuse current-KF map points into their matched loop-KF points
    (Map::mergeLoopClose, src/Map.cpp:333-352; MapPoint::mergedInto,
    src/MapPoint.cpp:314-324): the younger (current) point dies and every
    feature slot pointing at it is remapped to the older survivor, whose
    descriptor votes, parallax flag and viewing normal absorb the dead
    one's, and which takes over its observation list (entries of keyframes
    that already observe the survivor, or past the fan-in P, are dropped
    and their forward pointers cleared).

    Where two pairs write one slot (a survivor matched twice, or two
    features of one keyframe on one point) the written normal, remap
    value and observation slot are one of the candidates, as in JAX,
    whose ``.at[].set`` leaves the winner unspecified; vote sums, the
    parallax flag and observation counts accumulate exactly."""
    K, M = ms.K, ms.M
    P = ms.mp_obs_kf.shape[1]
    dev = ms.mp_pos.device
    j = match_idx.clamp(min=0).long()
    m_loop = _row(ms.kf_obs_mp, cand)
    m_cur = _row(ms.kf_obs_mp, k)[j]
    active = ((match_idx >= 0) & (m_loop >= 0) & (m_cur >= 0) & (m_loop != m_cur)
              & ms.mp_valid[m_loop.clamp(min=0).long()] & ms.mp_valid[m_cur.clamp(min=0).long()])
    # drop merge chains: a survivor that another pair kills would receive
    # features remapped into a dead slot
    no_mp = torch.zeros((M,), dtype=torch.bool, device=dev)
    dying = _scatter(no_mp, torch.where(active, m_cur, M), True)
    active = active & ~dying[m_loop.clamp(min=0).long()]
    dead = torch.where(active, m_cur, M)
    keep = torch.where(active, m_loop, M)
    dead_c = dead.clamp(0, M - 1).long()
    keep_c = keep.clamp(0, M - 1).long()

    remap = _scatter(torch.arange(M, dtype=_I32, device=dev), dead,
                     torch.where(active, m_loop, -1))
    new_obs = torch.where(ms.kf_obs_mp >= 0, remap[ms.kf_obs_mp.clamp(min=0).long()], -1)
    votes = _scatter(ms.mp_desc_votes, keep, ms.mp_desc_votes[dead_c], accumulate=True)
    touched = _scatter(no_mp, keep, True)
    desc = torch.where(touched[:, None], torch.where(votes >= 0, 1, -1).to(torch.int8),
                       ms.mp_desc)
    # the dead point's viewing normal folds into the survivor's running
    # mean, weighted by observation counts
    nd = ms.mp_normal.dtype
    blended = (ms.mp_normal[keep_c] * ms.mp_n_obs[keep_c].to(nd)[:, None]
               + ms.mp_normal[dead_c] * ms.mp_n_obs[dead_c].to(nd)[:, None])
    blended = blended / torch.clamp(torch.linalg.norm(blended, dim=-1, keepdim=True), min=1e-12)
    ms = ms._replace(
        kf_obs_mp=new_obs,
        mp_valid=_scatter(ms.mp_valid, dead, False),
        mp_good_prl=_scatter_max(ms.mp_good_prl, keep, ms.mp_good_prl[dead_c]),
        mp_desc_votes=votes,
        mp_desc=desc,
        mp_normal=_scatter(ms.mp_normal, keep, blended),
    )

    # transfer the dead points' observation lists to the survivors, one
    # fan-in slot at a time (each step reads the counts the last wrote)
    kf_obs_mp, mp_obs_kf = ms.kf_obs_mp, ms.mp_obs_kf
    mp_obs_feat, mp_n_obs = ms.mp_obs_feat, ms.mp_n_obs
    for p in range(P):
        src_kf = mp_obs_kf[dead_c, p]
        src_ft = mp_obs_feat[dead_c, p]
        src_live = active & (p < mp_n_obs[dead_c])
        dup = (mp_obs_kf[keep_c] == src_kf[:, None]).any(1)
        slot = mp_n_obs[keep_c]
        ok = src_live & ~dup & (slot < P)
        row = torch.where(ok, keep, M)
        col = torch.where(ok, slot, 0)
        # an entry not transferred must lose its forward pointer too
        dangling = src_live & ~ok
        fr = torch.where(dangling, src_kf.clamp(min=0), K)
        fc = torch.where(dangling, src_ft, 0)
        kf_obs_mp = _scatter(kf_obs_mp, (fr, fc), -1)
        mp_obs_kf = _scatter(mp_obs_kf, (row, col), src_kf)
        mp_obs_feat = _scatter(mp_obs_feat, (row, col), src_ft)
        mp_n_obs = _scatter(mp_n_obs, row, ok.to(_I32), accumulate=True)
    return ms._replace(kf_obs_mp=kf_obs_mp, mp_obs_kf=mp_obs_kf, mp_obs_feat=mp_obs_feat,
                       mp_n_obs=mp_n_obs)


def bow_detect(bank, query, eligible):
    """(best slot, best score) of the DBoW2 L1 score of ``query`` against
    the eligible rows of the (K, W) bank (DetectLoopClose,
    src/GlobalMapper.cpp:201-254); the single-device form of the JAX
    package's ``parallel/dist_loop.sharded_bow_detect``."""
    s = torch.where(eligible, vocab_mod.bow_score(bank, query),
                    torch.full((bank.shape[0],), -math.inf, device=bank.device))
    return torch.argmax(s), s.max()


def _global_edge_graph(ms: MapState):
    """The whole map's SE2 edge graph: the odometry preintegration chain
    (information = inverted preintegrated covariance) plus the loop and
    feature constraints, and the first valid keyframe as the gauge
    (src/GlobalMapper.cpp:374). Shared by the pose-graph and joint BAs.
    Returns (edge_i, edge_j, edge_meas, edge_info, edge_valid, fixed)."""
    K = ms.K
    dev, dtype = ms.kf_pose.device, ms.kf_pose.dtype
    nxt = ms.kf_pre_next
    chain_valid = ms.kf_valid & (nxt >= 0)
    eye = torch.eye(3, dtype=dtype, device=dev)[None]
    cov = torch.where(chain_valid[:, None, None], ms.kf_pre_cov + 1e-10 * eye, eye)
    edge_i = torch.cat([torch.arange(K, dtype=_I32, device=dev), ms.ftr_i]).clamp(min=0)
    edge_j = torch.cat([nxt.clamp(min=0), ms.ftr_j]).clamp(min=0)
    edge_meas = torch.cat([ms.kf_pre_meas, ms.ftr_meas])
    edge_info = torch.cat([linalg.inv3x3(cov), ms.ftr_info])
    edge_valid = torch.cat([chain_valid, ms.ftr_valid])
    first_kf = torch.argmax(ms.kf_valid.to(_I32))
    fixed = _put_row(torch.zeros((K,), dtype=torch.bool, device=dev), first_kf, True)
    return edge_i, edge_j, edge_meas, edge_info, edge_valid, fixed


def build_pose_graph(ms: MapState) -> PoseGraphProblem:
    """The GlobalBA pose-graph problem over the whole map."""
    edge_i, edge_j, edge_meas, edge_info, edge_valid, fixed = _global_edge_graph(ms)
    return PoseGraphProblem(poses=ms.kf_pose, pose_valid=ms.kf_valid, pose_fixed=fixed,
                            edge_i=edge_i, edge_j=edge_j, edge_meas=edge_meas,
                            edge_info=edge_info, edge_valid=edge_valid)


def _rigid_reanchor(ms: MapState, new_poses):
    """Every map point moved rigidly with its main keyframe's pose change
    (the reference re-derives positions from the main KF's view,
    src/GlobalMapper.cpp:506-531)."""
    mk = ms.mp_main_kf.clamp(min=0).long()
    T_delta = se2.to_se3(new_poses[mk]) @ se3.inv(se2.to_se3(ms.kf_pose[mk]))
    return se3.apply(T_delta, ms.mp_pos)


def apply_pose_graph_result(ms: MapState, new_poses) -> MapState:
    """Write back corrected poses and re-anchor every valid point on its
    main keyframe's correction."""
    moved = _rigid_reanchor(ms, new_poses)
    ride = ms.mp_valid & (ms.mp_main_kf >= 0)
    return ms._replace(kf_pose=new_poses,
                       mp_pos=torch.where(ride[:, None], moved, ms.mp_pos))


def run_global_ba(ms: MapState, iters: int = 15, huber: float = POSE_GRAPH_HUBER):
    """Global pose-graph BA over all keyframes + point re-anchoring
    (GlobalMapper::GlobalBA, src/GlobalMapper.cpp:328-535). Returns
    (MapState, info)."""
    new_poses, info = solve_pose_graph(build_pose_graph(ms), iters=iters, huber_delta=huber)
    return apply_pose_graph_result(ms, new_poses), info


def build_global_ba(ms: MapState, cfg: SystemConfig) -> BAProblem:
    """The FULL-map joint SE2-XYZ problem: every valid keyframe, every
    good-parallax map point, every live observation enumerated as the
    M×P grid of the inverse tables (o = m·P + p), the odometry chain and
    the loop/feature constraints (the pose graph's edges)."""
    M, P = ms.M, ms.mp_obs_kf.shape[1]
    dev = ms.kf_pose.device
    c = constants(cfg, dev)
    kf_sel = ms.kf_valid
    mp_sel = ms.mp_valid & ms.mp_good_prl
    obs_mp = torch.arange(M, dtype=_I32, device=dev).repeat_interleave(P)
    obs_kf_r = ms.mp_obs_kf.reshape(-1)
    live = (torch.arange(P, device=dev)[None, :] < ms.mp_n_obs[:, None]).reshape(-1)
    okf = obs_kf_r.clamp(min=0)
    oft = ms.mp_obs_feat.reshape(-1).clamp(min=0)
    ok_, om_, of_ = okf.long(), obs_mp.long(), oft.long()
    obs_valid = live & (obs_kf_r >= 0) & mp_sel[om_] & kf_sel[ok_]
    poses, points = ms.kf_pose, ms.mp_pos
    Tcw_k = kf_Tcw(poses, c["Tcb"])
    obs_info, obs_valid = obs_sigma_info(poses[ok_], points[om_], Tcw_k[ok_],
                                         ms.kf_octave[ok_, of_], obs_valid, cfg, c["cam"])
    edge_i, edge_j, edge_meas, edge_info, edge_valid, fixed = _global_edge_graph(ms)
    return BAProblem(
        poses=poses, points=points, pose_valid=kf_sel, pose_fixed=fixed, point_valid=mp_sel,
        obs_kf=okf, obs_mp=obs_mp, obs_uv=ms.kf_xy[ok_, of_], obs_info=obs_info,
        obs_valid=obs_valid, edge_i=edge_i, edge_j=edge_j, edge_meas=edge_meas,
        edge_info=edge_info, edge_valid=edge_valid,
    )


def _joint_problem(ms: MapState, cfg: SystemConfig) -> BAProblem:
    """``build_global_ba`` with the observations already inconsistent at
    the input state (chi2 ≥ th_huber2) demoted (the removeOutlierChi2
    gate, src/LocalMapper.cpp:172-230)."""
    c = constants(cfg, ms.kf_pose.device)
    prob = build_global_ba(ms, cfg)
    chi_in = obs_chi2(prob, c["cam"], c["Tcb"])
    return prob._replace(obs_valid=prob.obs_valid & (chi_in < cfg.th_huber2))


def _joint_apply(ms: MapState, prob: BAProblem, poses, points) -> MapState:
    """Write the joint solution back; points outside the solve (bad
    parallax) ride their main keyframe rigidly."""
    free = prob.pose_valid & ~prob.pose_fixed
    new_kf_pose = torch.where(free[:, None], poses, ms.kf_pose)
    anchored = _rigid_reanchor(ms, new_kf_pose)
    ride = ms.mp_valid & ~prob.point_valid & (ms.mp_main_kf >= 0)
    new_mp_pos = torch.where(prob.point_valid[:, None], points,
                             torch.where(ride[:, None], anchored, ms.mp_pos))
    return ms._replace(kf_pose=new_kf_pose, mp_pos=new_mp_pos)


def _joint_ba_cfg(ms: MapState, cfg: SystemConfig, iters: int, grid: bool = True) -> BAConfig:
    """The joint BA's solver settings: with ``grid`` the observation axis
    is the M×P grid (points accumulate by a reshape-sum; the distributed
    partition re-buckets observations by block, so it passes False), and
    LM starts at 1e-2 (full-map problems start from an outlier-contaminated
    state where a barely damped step overshoots)."""
    return BAConfig(iters=iters, huber_delta=float(cfg.th_huber2) ** 0.5,
                    obs_grid_p=int(ms.mp_obs_kf.shape[1]) if grid else 0,
                    lm_init_lambda=1e-2)


def run_global_ba_joint(ms: MapState, cfg: SystemConfig, iters: int = 5):
    """Joint full-map pose+point LM after a loop closure, on the
    pose-graph-corrected, merge-fused map: ``solve_local_ba`` at bank
    scale, so the Schur kernel runs at (max_kfs, max_mps). Returns
    (MapState, info)."""
    c = constants(cfg, ms.kf_pose.device)
    prob = _joint_problem(ms, cfg)
    poses, points, info = solve_local_ba(prob, c["cam"], c["Tcb"], _joint_ba_cfg(ms, cfg, iters))
    return _joint_apply(ms, prob, poses, points), info


def run_global_ba_dist(ms: MapState, mesh, iters: int = 15, cg_iters: int | None = None,
                       huber: float = POSE_GRAPH_HUBER):
    """The GlobalBA pose graph solved with its edges split over ``mesh``
    (matrix-free PCG, ``parallel/dist_posegraph.py``) instead of the dense
    factorization; ``cg_iters`` defaults to the bank's capacity (chain-
    dominated graphs want ≈ K). Returns (MapState, info)."""
    from .parallel.dist_posegraph import dist_solve_pose_graph

    new_poses, info = dist_solve_pose_graph(
        build_pose_graph(ms), mesh, iters=iters, cg_iters=int(ms.K) if cg_iters is None
        else cg_iters, huber_delta=float(huber), axis=mesh.axis_names[0])
    return apply_pose_graph_result(ms, new_poses.to(ms.kf_pose.device)), info


def run_global_ba_joint_dist(ms: MapState, cfg: SystemConfig, mesh, iters: int = 5):
    """The joint full-map GBA with the map-point axis partitioned over
    ``mesh`` (``parallel/dist_ba.sharded_solve_local_ba``: one psum of the
    blocks' Schur-reduced camera systems per LM step, K3 on each CUDA
    block at (K, ⌈M/n⌉)). Returns (MapState, info)."""
    from .parallel.dist_ba import sharded_solve_local_ba

    c = constants(cfg, ms.kf_pose.device)
    prob = _joint_problem(ms, cfg)
    poses, points, info = sharded_solve_local_ba(
        prob, c["cam"], c["Tcb"], _joint_ba_cfg(ms, cfg, iters, grid=False), mesh,
        axis=mesh.axis_names[0])
    dev = ms.kf_pose.device
    return _joint_apply(ms, prob, poses.to(dev), points.to(dev)), info


def loop_stage(ms: MapState, k, bank, vocab, last_loop, gba_cooldown, cfg: SystemConfig, *,
               n_trials: int, gba_iters: int, joint_iters: int, min_between: int,
               have_vocab: bool = True, generator: torch.Generator | None = None,
               gumbel=None):
    """The per-keyframe global-mapping stage: feature-edge candidates, BoW
    detect over the bank (its row ``k`` written first), one batched
    verify + constraint build of the 4 partners and the loop candidate,
    the gates, the feature edges (applied by mask), then ONE host read of
    the decisions; only when they fire does the closure branch run:
    evicting edge + merge on a verified loop, the pose-graph GlobalBA on a
    loop or on a renewed feature graph outside the cooldown
    (src/GlobalMapper.cpp:87-155), the joint BA on a loop.

    ``last_loop``: (2,) int32 [cand, k] of the last closure, [-1, -1] if
    none (the temporal throttle); ``gba_cooldown``: a GBA ran on the last
    keyframe. ``gumbel``: (5, n_trials, N) RANSAC noise. Returns
    (ms, bank, outs): host values fired/cand/k/evicted/n_feat_edges/
    renewal_gba/cooldown, and tensors midx and last_loop.

    Spans: ``loop.detect`` through the decision read, then
    ``loop.correct`` where it runs. The counts of ``loop.detect``:
    ``verified``, the real candidates among the batched verification's 5
    slots (an empty slot is verified too, against keyframe 0), ``fired``,
    ``renewal`` and ``feat_edges``."""
    with span("loop.detect") as s:
        K = ms.K
        dev = ms.kf_pose.device
        k = torch.as_tensor(k, device=dev).to(_I32)
        cands = select_feat_pairs(ms, k)
        if have_vocab:
            v, _ = vocab_mod.bow_transform(vocab, _row(ms.kf_desc, k), _row(ms.kf_feat_valid, k))
            bank = _put_row(bank, k, v)
            eligible = ms.kf_valid & (torch.arange(K, device=dev) <= k - cfg.gm_dcl_min_kfid_offset)
            best_i, best_s = bow_detect(bank, v, eligible)
            throttled = (last_loop[1] >= 0) & (k - last_loop[1] < min_between)
            loop_ok = ~throttled & (best_s >= cfg.gm_dcl_min_score_best)
            loop_cand = torch.where(loop_ok, best_i.to(_I32), -1)
        else:
            loop_cand = torch.full((), -1, dtype=_I32, device=dev)

        vec = torch.cat([cands, loop_cand[None]])
        midx_b, n_kp_b, n_mp_b, n_cur_b, meas_b, info_b, n_good_b = verify_and_build_batch(
            ms, k, vec.clamp(min=0), cfg, n_trials, generator=generator, gumbel=gumbel)

        # sparsified feature edges, applied by mask (UpdateFeatGraph,
        # src/Map.cpp:857-889)
        n_feat = torch.zeros((), dtype=_I32, device=dev)
        for c in range(cands.shape[0]):
            ok_c = (vec[c] >= 0) & (n_mp_b[c] >= 10) & (n_good_b[c] >= 10)
            ms = add_ftr_edge(ms, vec[c].clamp(min=0), k, meas_b[c], info_b[c], active=ok_c)
            n_feat = n_feat + ok_c.to(_I32)

        n_kp, n_mp, n_cur, n_good = n_kp_b[-1], n_mp_b[-1], n_cur_b[-1], n_good_b[-1]
        fire = ((loop_cand >= 0)
                & (n_mp >= cfg.gm_vcl_num_min_match_mp)
                & (n_kp >= cfg.gm_vcl_num_min_match_kp)
                & (n_mp.to(torch.float32)
                   >= cfg.gm_vcl_ratio_min_match_mp * torch.clamp(n_cur, min=1).to(torch.float32))
                & (n_good >= cfg.gm_vcl_num_min_match_mp))
        evicted = fire & ms.ftr_valid.all()
        # the feat-graph-renewal GlobalBA (src/GlobalMapper.cpp:87-147)
        renew = ~fire & (n_feat > 0) & (not gba_cooldown)
        # the one host read of the keyframe's decisions
        fired, renewal, ev, cand_h, k_h, n_feat_h, n_ver = (
            int(x) for x in torch.stack([fire.to(_I32), renew.to(_I32), evicted.to(_I32),
                                         loop_cand, k, n_feat, (vec >= 0).sum(dtype=_I32)]).cpu())
        s.count("verified", n_ver)
        s.count("fired", fired)
        s.count("renewal", renewal)
        s.count("feat_edges", n_feat_h)
    cand_c = max(cand_h, 0)
    midx = midx_b[-1]
    if fired or renewal:
        with span("loop.correct"):
            if fired:
                with span("loop.merge"):
                    ms = add_ftr_edge(ms, cand_c, k, meas_b[-1], info_b[-1], evict_if_full=True)
                    ms = merge_loop_mps(ms, k, cand_c, midx)
            with span("loop.pose_graph"):
                ms, _ = run_global_ba(ms, iters=gba_iters, huber=cfg.gm_pg_huber)
            if fired and joint_iters > 0:
                with span("loop.joint_ba"):
                    ms, _ = run_global_ba_joint(ms, cfg, iters=joint_iters)
    new_last = (torch.tensor([cand_c, k_h], dtype=_I32, device=dev) if fired
                else torch.as_tensor(last_loop, device=dev).to(_I32))
    outs = dict(fired=bool(fired), cand=cand_h, k=k_h, evicted=bool(ev), n_feat_edges=n_feat_h,
                midx=midx, last_loop=new_last, renewal_gba=bool(renewal),
                cooldown=bool(fired or renewal))
    return ms, bank, outs


class LoopCloser:
    """Host-driven loop-closing controller (the GlobalMapper thread's
    role): the self-trained vocabulary and the per-keyframe BoW bank.

    ``detect_loops=False`` keeps feature-edge maintenance and the
    feat-graph-renewal GlobalBA but detects no loops (the reference cannot
    turn its GlobalMapper off, src/GlobalMapper.cpp:87-147). RANSAC and
    the vocabulary's seed rows draw from ``generator`` (seeded 42 on the
    device when not given); parity tests may set ``stage_gumbel``, a
    callable giving each keyframe's (5, trials, N) RANSAC noise.

    ``mesh``: a ``parallel.mesh.Mesh``; with more than one block
    (``_dist``) the bank is split over it and the stage runs staged with
    the distributed solvers (``on_new_kf``, or ``start_async`` and
    ``advance``); its first block's device must be ``device``."""

    def __init__(self, cfg: SystemConfig, n_words: int | None = None, min_kfs_to_train: int = 2,
                 retrain_factor: float = 2.0, global_ba_iters: int | None = None,
                 detect_loops: bool = True, device=None,
                 generator: torch.Generator | None = None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self._dist = mesh is not None and mesh.size > 1
        if mesh is not None and not same_device(mesh.devices[0], self.device):
            raise ValueError(f"the mesh's first block {mesh.devices[0]} is not the loop "
                             f"closer's device {self.device}")
        self.detect_loops = detect_loops
        # the flat vocabulary scales with the keyframe capacity: score
        # separation between a true revisit and the best impostor scales
        # ~W/K and needs W ≳ 4·max_kfs (the JAX package's vocab-scale
        # study); W is capped at 16384
        if n_words is None:
            n_words = int(min(max(1024, 4 * cfg.cap.max_kfs), 16384))
        if n_words < 4 * cfg.cap.max_kfs:
            warnings.warn(
                f"flat vocabulary width W={n_words} < 4*max_kfs={4 * cfg.cap.max_kfs}: "
                "loop-detection score separation collapses as the map fills. Keep "
                "max_kfs <= W/4 or expect missed/false loop closures at scale.",
                stacklevel=2)
        self.n_words = n_words
        # vocabulary lifecycle: bootstrap at min_kfs_to_train keyframes,
        # retrain whenever the insertion count grows by retrain_factor
        # (insertions, not live slots: compaction reuses slots)
        self.min_kfs_to_train = min_kfs_to_train
        self.retrain_factor = retrain_factor
        self._n_inserts = 0
        self._trained_at_nkf = 0
        self.global_ba_iters = cfg.global_iter if global_ba_iters is None else global_ba_iters
        self.min_kfs_between_loops = 5
        self.vocab = None
        self.bank = None          # (K, W) BoW vectors
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(42)
        self.generator = generator
        self.stage_gumbel = None
        self.n_loops_closed = 0
        self.n_ftr_evicted = 0     # bank-full closures that evicted an edge
        self.n_renewal_gbas = 0
        self.n_vocab_trainings = 0
        # a global correction ran on the last keyframe (mbGlobalBALastLoop,
        # src/GlobalMapper.cpp:142-155)
        self._gba_cooldown = False
        self._last_loop_host: tuple[int, int] | None = None
        self._last_loop_dev = torch.tensor([-1, -1], dtype=_I32, device=self.device)
        self.last_loop_midx = None   # (N,) loop→cur feature matches
        # host reads of the staged pipeline's last keyframe (its want tuples)
        self.last_kf_pulls = 0

    @property
    def last_loop(self) -> tuple[int, int] | None:
        """(loop slot, current slot) of the last closure."""
        return self._last_loop_host

    @last_loop.setter
    def last_loop(self, v):
        # compaction remaps slot ids; the stage's throttle reads the tensor
        self._last_loop_host = None if v is None else (int(v[0]), int(v[1]))
        self._last_loop_dev = torch.tensor([-1, -1] if v is None else [v[0], v[1]],
                                           dtype=_I32, device=self.device)

    def on_new_kf_fused(self, ms: MapState, k) -> MapState:
        """The per-keyframe stage (``loop_stage``) for keyframe slot ``k``
        (an int or a 0-d tensor), after the vocabulary lifecycle; the
        counters update at the stage's host read."""
        self._n_inserts += 1
        have_vocab = self.detect_loops and self._ensure_vocab(ms, self._n_inserts)
        noise = (dict(generator=self.generator) if self.stage_gumbel is None
                 else dict(gumbel=torch.as_tensor(self.stage_gumbel()).to(self.device)))
        ms, bank, outs = loop_stage(
            ms, k, self.bank if have_vocab else None, self.vocab, self._last_loop_dev,
            self._gba_cooldown, self.cfg, n_trials=self.cfg.cap.ransac_trials,
            gba_iters=self.global_ba_iters, joint_iters=self.cfg.gm_joint_ba_iters,
            min_between=self.min_kfs_between_loops, have_vocab=have_vocab, **noise)
        if have_vocab:
            self.bank = bank
        self._gba_cooldown = outs["cooldown"]
        if outs["fired"]:
            self.n_loops_closed += 1
            self._last_loop_host = (outs["cand"], outs["k"])
            self._last_loop_dev = outs["last_loop"]
            self.last_loop_midx = outs["midx"]
        self.n_renewal_gbas += int(outs["renewal_gba"])
        self.n_ftr_evicted += int(outs["evicted"])
        return ms

    def on_new_kf(self, ms: MapState, k) -> MapState:
        """The per-keyframe stage: on a mesh the staged pipeline run to
        completion (``start_async``, then ``advance`` on each stage's
        values read back), else the fused ``loop_stage``."""
        if not self._dist:
            return self.on_new_kf_fused(ms, k)
        pending = self.start_async(ms, k)
        while pending is not None:
            ms, pending, _closed = self.advance(ms, pending, self._pull(pending["want"]))
        return ms

    def _pull(self, want):
        """A host read of a stage's values."""
        self.last_kf_pulls += 1
        return tuple(w.cpu().numpy() for w in want)

    def start_async(self, ms: MapState, k) -> dict:
        """Stage A of the staged per-keyframe pipeline: the vocabulary
        lifecycle, the feature-edge candidates and the BoW detect over the
        (split) bank, dispatched with no host read. Returns a pending record
        whose ``want`` tensors the caller reads (``_pull``, or a copy
        started at dispatch) before ``advance``."""
        k = int(k)
        self.last_kf_pulls = 0
        self._n_inserts += 1
        have_vocab = self.detect_loops and self._ensure_vocab(ms, self._n_inserts)
        cands = select_feat_pairs(ms, k)
        if have_vocab:
            from .parallel.dist_loop import ShardedRows, sharded_bow_detect

            v, _ = vocab_mod.bow_transform(self.vocab, _row(ms.kf_desc, k),
                                           _row(ms.kf_feat_valid, k))
            self.bank = (self.bank.put_row(k, v) if isinstance(self.bank, ShardedRows)
                         else _put_row(self.bank, k, v))
            ids = torch.arange(ms.K, device=ms.kf_pose.device)
            eligible = ms.kf_valid & (ids <= k - self.cfg.gm_dcl_min_kfid_offset)
            best_i, best_s = sharded_bow_detect(self.bank, v, eligible)
            want = (cands, best_i.to(self.device), best_s.to(self.device))
        else:
            want = (cands,)
        return {"stage": "detect", "k": k, "have_vocab": have_vocab, "want": want}

    def advance(self, ms: MapState, pending: dict, fetched):
        """Consume the host values read for ``pending["want"]`` and run the
        next stage. Returns (ms, next pending or None, closed): ``closed``
        when a global correction moved keyframe poses (the caller's
        tracking gauge must be re-based)."""
        cfg, dev = self.cfg, self.device
        k = pending["k"]
        if pending["stage"] == "detect":
            cands = fetched[0]
            # the temporal throttle and the BoW score gate, on the host
            # (DetectLoopClose accept, src/GlobalMapper.cpp:206-254)
            throttled = (self.last_loop is not None
                         and k - self.last_loop[1] < self.min_kfs_between_loops)
            loop_cand = -1
            if (pending["have_vocab"] and not throttled
                    and float(fetched[2]) >= cfg.gm_dcl_min_score_best):
                loop_cand = int(fetched[1])
            feat_cands = [int(c) for c in cands if int(c) >= 0]
            if loop_cand < 0 and not feat_cands:
                self._gba_cooldown = False          # src/GlobalMapper.cpp:151-155
                return ms, None, False
            # ONE batched verify + constraint build: the feature-edge
            # candidates, the loop candidate in the last slot (width 1 when
            # there is no feature candidate)
            C = 1 if not feat_cands else len(cands) + 1
            vec = [-1] * C
            vec[:len(feat_cands)] = feat_cands
            vec[-1] = loop_cand
            slots = torch.tensor([max(c, 0) for c in vec], dtype=_I32, device=dev)
            midx_b, n_kp_b, n_mp_b, n_cur_b, meas_b, info_b, n_good_b = verify_and_build_batch(
                ms, k, slots, cfg, cfg.cap.ransac_trials, generator=self.generator)
            return ms, {
                "stage": "gates", "k": k, "feat_cands": feat_cands, "loop_cand": loop_cand,
                "midx_b": midx_b, "meas_b": meas_b, "info_b": info_b,
                "want": (n_kp_b, n_mp_b, n_cur_b, n_good_b, ms.ftr_valid.all()),
            }, False

        assert pending["stage"] == "gates"
        feat_cands, loop_cand = pending["feat_cands"], pending["loop_cand"]
        meas_b, info_b = pending["meas_b"], pending["info_b"]
        n_kp_h, n_mp_h, n_cur_h, n_good_h, bank_full = fetched
        feat_renewed = False
        for c, cand_c in enumerate(feat_cands):
            if int(n_mp_h[c]) < 10 or int(n_good_h[c]) < 10:
                continue
            ms = add_ftr_edge(ms, cand_c, k, meas_b[c], info_b[c])
            feat_renewed = True

        def global_ba(ms):
            if self._dist:
                return run_global_ba_dist(ms, self.mesh, iters=self.global_ba_iters,
                                          huber=cfg.gm_pg_huber)
            return run_global_ba(ms, iters=self.global_ba_iters, huber=cfg.gm_pg_huber)

        def renewal_or_clear(ms):
            # the feat-graph-renewal GlobalBA (src/GlobalMapper.cpp:142-147),
            # else the cooldown clears (:151-155)
            if feat_renewed and not self._gba_cooldown:
                ms, _ = global_ba(ms)
                self._gba_cooldown = True
                self.n_renewal_gbas += 1
                return ms, True
            self._gba_cooldown = False
            return ms, False

        if loop_cand < 0:
            ms, corrected = renewal_or_clear(ms)
            return ms, None, corrected
        n_kp, n_mp, n_cur, n_good = (int(n_kp_h[-1]), int(n_mp_h[-1]), int(n_cur_h[-1]),
                                     int(n_good_h[-1]))
        if (n_mp < cfg.gm_vcl_num_min_match_mp or n_kp < cfg.gm_vcl_num_min_match_kp
                or n_mp < cfg.gm_vcl_ratio_min_match_mp * max(n_cur, 1)
                or n_good < cfg.gm_vcl_num_min_match_mp):
            ms, corrected = renewal_or_clear(ms)
            return ms, None, corrected
        if bool(bank_full):
            self.n_ftr_evicted += 1       # add_ftr_edge evicts the weakest edge
        midx = pending["midx_b"][-1]
        ms = add_ftr_edge(ms, loop_cand, k, meas_b[-1], info_b[-1], evict_if_full=True)
        ms = merge_loop_mps(ms, k, loop_cand, midx)
        ms, _ = global_ba(ms)
        if cfg.gm_joint_ba_iters > 0:
            if self._dist:
                ms, _ = run_global_ba_joint_dist(ms, cfg, self.mesh, iters=cfg.gm_joint_ba_iters)
            else:
                ms, _ = run_global_ba_joint(ms, cfg, iters=cfg.gm_joint_ba_iters)
        self.n_loops_closed += 1
        self._gba_cooldown = True
        self.last_loop = (loop_cand, k)
        self.last_loop_midx = midx
        return ms, None, True

    def adopt_vocab(self, vocab, ms: MapState):
        """Install a vocabulary and score every existing keyframe into the
        bank; an adopted vocabulary counts as trained now, and the
        insertion counter starts from the map's size (a resumed map)."""
        self.vocab = vocab_mod.Vocabulary(*(t.to(self.device) for t in vocab))
        self.rebuild_bank(ms)
        self._n_inserts = max(self._n_inserts, int(ms.n_kf))
        self._trained_at_nkf = max(self._trained_at_nkf, self._n_inserts)

    def rebuild_bank(self, ms: MapState):
        """Every keyframe's BoW vector under the current vocabulary (after
        a slot remap; the retrain schedule is untouched)."""
        bank, _ = vocab_mod.bow_transform(self.vocab, ms.kf_desc,
                                          ms.kf_feat_valid & ms.kf_valid[:, None])
        self.bank = self._place_bank(bank)

    def _place_bank(self, bank):
        """On a mesh, the bank split along its keyframe axis
        (``parallel/dist_loop.shard_bank``) when the mesh divides it."""
        if self._dist and bank.shape[0] % self.mesh.size == 0:
            from .parallel.dist_loop import shard_bank

            return shard_bank(bank, self.mesh, axis=self.mesh.axis_names[0])
        return bank

    def _ensure_vocab(self, ms: MapState, n_inserts: int) -> bool:
        if self.vocab is not None and n_inserts < self._trained_at_nkf * self.retrain_factor:
            return True
        if n_inserts < self.min_kfs_to_train:
            return self.vocab is not None
        # (re)train on all live keyframes, one document per keyframe
        with span("loop.vocab"):
            K, N = ms.K, ms.N
            valid = (ms.kf_feat_valid & ms.kf_valid[:, None]).reshape(-1)
            doc_ids = torch.arange(K, dtype=_I32, device=ms.kf_desc.device).repeat_interleave(N)
            self.adopt_vocab(vocab_mod.train_vocab(ms.kf_desc.reshape(-1, 256), valid,
                                                   n_words=self.n_words, doc_ids=doc_ids,
                                                   n_docs_cap=K, generator=self.generator), ms)
        self._trained_at_nkf = n_inserts
        self.n_vocab_trainings += 1
        return True
