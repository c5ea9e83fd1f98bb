"""Local mapping stage: keyframe insertion, data association, pruning and
local BA (port of the synchronous path of se2lam_tpu.localmap; reference
LocalMapper thread + Map local-graph machinery, src/LocalMapper.cpp,
src/Map.cpp:146-331,891-1053).

Every function takes a ``MapState`` and returns a new one; no input
tensor is written in place. Keyframe and map-point slot arguments may be
Python ints or 0-d tensors on the map's device; the functions read
nothing back to the host.

Two JAX idioms need care in torch:

- a scatter with ``mode="drop"`` routes the rows it drops to the index
  one past the end; here the target gets one spare row, which is sliced
  off after the scatter (``_scatter``);
- a JAX gather clamps out-of-range indices, a torch gather raises: every
  gather index is clamped as the JAX code clamps it (or is in range by
  construction).

``lax.top_k`` / ``argsort`` tie order (lower index first) comes from the
stable sort in ``ops.topk``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import factors
from .config import SystemConfig
from .frontend.orb import OrbFeatures
from .frontend.windowed_match import match_by_projection_streamed
from .mapstate import MapState, kf_Tcw
from .ops import linalg, se3
from .ops.topk import top_k
from .ops.triangulate import check_parallax, triangulate
from .solver.ba import BAConfig, BAProblem, solve_local_ba
from .tracking import constants

__all__ = [
    "insert_first_kf",
    "kf_track_seed",
    "insert_and_optimize",
    "add_keyframe",
    "prune_redundant_kf",
    "local_graph_masks",
    "obs_sigma_info",
    "LocalWindow",
    "build_local_ba",
    "run_local_ba",
    "local_obs_chi2",
    "remove_outlier_obs",
    "recompute_covis",
    "cull_weak_mps",
    "compact_mps",
    "relieve_mp_pressure",
    "compact_map",
]

_I32 = torch.int32
# cos(30°) as the JAX package computes it, in f32
_COS_30 = float(np.cos(np.deg2rad(np.float32(30.0))))


def _idx(k, dev):
    """A slot as a (1,) int64 index tensor on ``dev``."""
    return torch.as_tensor(k, device=dev).reshape(1).long()


def _row(x, k):
    """x[k] for a slot ``k`` (int or 0-d tensor), without a host read."""
    return x.index_select(0, _idx(k, x.device))[0]


def _put_row(x, k, v):
    """A copy of ``x`` with row ``k`` set to ``v``."""
    y = x.clone()
    y.index_put_((_idx(k, x.device),), torch.as_tensor(v, dtype=x.dtype, device=x.device)
                 .expand(x.shape[1:])[None])
    return y


def _scatter(x, idx, vals, accumulate=False):
    """``x.at[idx].set(vals, mode="drop")`` (or ``.add``) for indices in
    [0, len(x)]: index len(x) is dropped. ``idx`` may be a tuple for a
    multi-axis scatter whose first axis drops. Returns a new tensor."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = tuple(i.long() for i in idx)
    ext = torch.cat([x, x[:1]])
    vals = torch.as_tensor(vals, dtype=x.dtype, device=x.device)
    ext.index_put_(idx, vals.expand(idx[0].shape + x.shape[len(idx):]), accumulate=accumulate)
    return ext[: x.shape[0]]


def _where_state(cond, new: MapState, old: MapState) -> MapState:
    return MapState(*(torch.where(cond, a, b) for a, b in zip(new, old)))


def _write_kf_record(ms: MapState, k, feats: OrbFeatures, pose, odom):
    return ms._replace(
        kf_pose=_put_row(ms.kf_pose, k, pose),
        kf_odom=_put_row(ms.kf_odom, k, odom),
        kf_valid=_put_row(ms.kf_valid, k, True),
        kf_xy=_put_row(ms.kf_xy, k, feats.xy),
        kf_octave=_put_row(ms.kf_octave, k, feats.octave),
        kf_angle=_put_row(ms.kf_angle, k, feats.angle),
        kf_feat_valid=_put_row(ms.kf_feat_valid, k, feats.valid),
        kf_desc=_put_row(ms.kf_desc, k, feats.desc_pm1),
    )


def insert_first_kf(ms: MapState, feats: OrbFeatures, pose, odom) -> MapState:
    """First frame becomes KF 0 with no map points (Track::mCreateFrame,
    src/Track.cpp:105-120)."""
    ms = _write_kf_record(ms, ms.n_kf, feats, pose, odom)
    return ms._replace(n_kf=ms.n_kf + 1)


def kf_track_seed(ms: MapState, k):
    """(view_mp, obs_mask) of KF ``k`` for Track::resetLocalTrack, masked
    by mp_valid so culled points don't count as tracked."""
    obs = _row(ms.kf_obs_mp, k)
    mask = (obs >= 0) & ms.mp_valid[obs.clamp(min=0).long()]
    return _row(ms.kf_view_mp, k), mask


def insert_and_optimize(ms: MapState, feats: OrbFeatures, pose, odom, ref_kf, match_idx,
                        local_mps, local_mp_valid, good_prl, pre_meas, pre_cov, protect,
                        cfg: SystemConfig):
    """The keyframe-insertion mapping stage: add_keyframe → two pruning
    rounds (the JAX package's ``prune_rounds`` default, the only value its
    callers use) → local BA → the tracking reseed inputs
    (LocalMapper::addNewKF + run-loop order,
    src/LocalMapper.cpp:51-85,304-364). One compiled program in JAX; eager
    ops here.

    Returns (ms, k, view_mp, obs_mask, ba_info)."""
    ms, k = add_keyframe(ms, feats, pose, odom, ref_kf, match_idx, local_mps,
                         local_mp_valid, good_prl, pre_meas, pre_cov, cfg)
    for _ in range(2):
        ms, _kid = prune_redundant_kf(ms, k, protect=protect, cfg=cfg)
    ms, ba_info = run_local_ba(ms, k, cfg)
    view_mp, obs_mask = kf_track_seed(ms, k)
    return ms, k, view_mp, obs_mask, ba_info


def _append_obs(ms: MapState, mp_idx, kf, feat_idx, active):
    """Append observation (kf, feat) to each active map point
    (MapPoint::addObservation, src/MapPoint.cpp:104-122); overflow past the
    fan-in capacity P is dropped. Returns (new MapState, (N,) bool mask of
    the appends that landed): callers mask their forward writes by it."""
    M, P = ms.M, ms.mp_obs_kf.shape[1]
    m = mp_idx.clamp(0, M - 1)
    slot = ms.mp_n_obs[m.long()]
    ok = active & (slot < P)
    row = torch.where(ok, m, M)
    col = torch.where(ok, slot, 0)
    kf_full = torch.as_tensor(kf, dtype=_I32, device=mp_idx.device).expand(mp_idx.shape)
    return ms._replace(
        mp_obs_kf=_scatter(ms.mp_obs_kf, (row, col), kf_full),
        mp_obs_feat=_scatter(ms.mp_obs_feat, (row, col), feat_idx),
        mp_n_obs=_scatter(ms.mp_n_obs, row, ok.to(_I32), accumulate=True),
    ), ok


def _fw_mask_from_inverse(K, N, mp_obs_kf, mp_obs_feat, mp_mask):
    """(K, N) bool: forward-table entries whose map point is in
    ``mp_mask``, scattered from the inverse observation lists (exact when
    ``mp_mask ⊆ mp_valid``)."""
    sel = (mp_obs_kf >= 0) & mp_mask[:, None]
    rows = torch.where(sel, mp_obs_kf, K)
    cols = mp_obs_feat.clamp(min=0)
    out = torch.zeros((K, N), dtype=torch.bool, device=mp_obs_kf.device)
    return _scatter(out, (rows, cols), True)


def _octave_dist_gates(octave, dist, scale_factor, n_levels):
    """min/max view-distance gates from the creation octave
    (MapPoint::updateMainKFandDescriptor, src/MapPoint.cpp:276-289)."""
    level_scale = scale_factor ** octave.to(torch.float32)
    max_d = dist * level_scale * scale_factor
    min_d = max_d / (scale_factor ** n_levels)
    return min_d, max_d


def add_keyframe(ms: MapState, feats: OrbFeatures, pose, odom, ref_kf, match_idx,
                 local_mps, local_mp_valid, good_prl, pre_meas, pre_cov, cfg: SystemConfig):
    """Insert the current frame as a keyframe with full data association
    (LocalMapper::addNewKF/findCorrespd, src/LocalMapper.cpp:51-170):
    (a) inherit map points tracked from the reference KF, (b) mint new
    points from this window's triangulations, (c) projection-match the
    rest of the map into the new KF; then parallax promotion, descriptor
    votes and normals, covisibility, the odometry chain and the no-parallax
    cull. Returns (new MapState, new KF slot; -1 and the old state when
    the KF bank is full)."""
    K, M, N = ms.K, ms.M, ms.N
    dev, dtype = ms.kf_pose.device, ms.kf_pose.dtype
    c = constants(cfg, dev)
    Tcb, Kmat = c["Tcb"], c["Kmat"]
    arangeN = torch.arange(N, dtype=_I32, device=dev)
    ms_in = ms
    ref_kf = torch.as_tensor(ref_kf, dtype=_I32, device=dev)
    k = torch.clamp(ms.n_kf, max=K - 1)   # clamp writes; the guard below decides
    pose = torch.as_tensor(pose, dtype=dtype, device=dev)

    ms = _write_kf_record(ms, k, feats, pose, odom)

    ref_pose = _row(ms.kf_pose, ref_kf)
    Tcw_new = kf_Tcw(pose, Tcb)
    Tcw_ref = kf_Tcw(ref_pose, Tcb)
    Twc_ref = se3.inv(Tcw_ref)
    cam_center_new = se3.inv(Tcw_new)[:3, 3]
    cam_center_ref = Twc_ref[:3, 3]

    j = match_idx.clamp(min=0)              # current-frame feature per ref feature
    jl = j.long()
    m_ref = _row(ms.kf_obs_mp, ref_kf)      # MP per ref feature (-1 none)

    # ---- (a) inherit tracked MPs (src/LocalMapper.cpp:94-115) ----
    inherit = (match_idx >= 0) & (m_ref >= 0) & ms.mp_valid[m_ref.clamp(min=0).long()]
    ms, inh_ok = _append_obs(ms, m_ref, k, j, inherit)

    # ---- (b) mint new MPs from triangulations (src/LocalMapper.cpp:148-166) ----
    mint = (match_idx >= 0) & (m_ref < 0) & local_mp_valid & feats.valid[jl]
    pos_w = se3.apply(Twc_ref, local_mps)
    view_dir = pos_w - cam_center_ref
    dist = torch.linalg.norm(view_dir, dim=-1)
    normal = view_dir / torch.clamp(dist, min=1e-12)[..., None]
    ref_octave = _row(ms.kf_octave, ref_kf)
    min_d, max_d = _octave_dist_gates(ref_octave, dist, cfg.scale_factor, cfg.max_level)

    rank = torch.cumsum(mint.to(_I32), 0, dtype=_I32) - 1
    slot = ms.n_mp + rank
    ok = mint & (slot < M)
    srow = torch.where(ok, slot, M)          # drop overflow
    ms = ms._replace(
        mp_pos=_scatter(ms.mp_pos, srow, pos_w),
        mp_valid=_scatter(ms.mp_valid, srow, True),
        mp_good_prl=_scatter(ms.mp_good_prl, srow, good_prl),
        mp_desc=_scatter(ms.mp_desc, srow, feats.desc_pm1[jl]),
        # bit votes start from the ref-KF observation; the vote update
        # below adds the current frame's descriptor
        mp_desc_votes=_scatter(ms.mp_desc_votes, srow, _row(ms.kf_desc, ref_kf).to(torch.int16)),
        mp_normal=_scatter(ms.mp_normal, srow, normal),
        mp_main_kf=_scatter(ms.mp_main_kf, srow, ref_kf),
        mp_main_feat=_scatter(ms.mp_main_feat, srow, arangeN),
        mp_main_octave=_scatter(ms.mp_main_octave, srow, ref_octave),
        mp_min_dist=_scatter(ms.mp_min_dist, srow, min_d),
        mp_max_dist=_scatter(ms.mp_max_dist, srow, max_d),
        n_mp=ms.n_mp + ok.sum(dtype=_I32),
    )
    # observations in both KFs (fresh points: fan-in 0 → always lands)
    ms, _ = _append_obs(ms, srow, ref_kf, arangeN, ok)
    ms, _ = _append_obs(ms, srow, k, j, ok)
    # wire feature → MP in the ref-KF row; back-fill its camera-frame view
    # estimate and anisotropic info (src/MapPoint.cpp:150-170)
    info_ref_mint, _ = factors.se3_to_xyz_info(local_mps, Tcw_ref, Tcw_new, cfg.fx)
    ms = ms._replace(
        kf_obs_mp=_put_row(ms.kf_obs_mp, ref_kf, torch.where(ok, slot, m_ref)),
        kf_view_mp=_put_row(ms.kf_view_mp, ref_kf, torch.where(
            ok[:, None], local_mps, _row(ms.kf_view_mp, ref_kf))),
        kf_view_info=_put_row(ms.kf_view_info, ref_kf, torch.where(
            ok[:, None, None], info_ref_mint, _row(ms.kf_view_info, ref_kf))),
    )
    # new-KF observation row: per current feature, MP from inherit or mint
    none = torch.full((N,), -1, dtype=_I32, device=dev)
    inh_row = _scatter(none, torch.where(inh_ok, j, N), torch.where(inh_ok, m_ref, -1))
    mint_row = _scatter(none, torch.where(ok, j, N), torch.where(ok, slot, -1))
    obs_row = torch.where(mint_row >= 0, mint_row, inh_row)

    # ---- (c) projection-match the local map into the new KF
    #      (MatchByProjection + acceptNewObserve, src/LocalMapper.cpp:117-147,
    #       src/MapPoint.cpp:202-209) ----
    no_mp = torch.zeros((M,), dtype=torch.bool, device=dev)
    already = _scatter(no_mp, torch.where(obs_row >= 0, obs_row, M), True)
    lc = se3.apply(Tcw_new, ms.mp_pos)            # (M, 3) camera frame
    z = lc[..., 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    u = cfg.fx * lc[..., 0] / zs + cfg.cx
    v = cfg.fy * lc[..., 1] / zs + cfg.cy
    mp_dist = torch.linalg.norm(ms.mp_pos - cam_center_new, dim=-1)
    vdir = (ms.mp_pos - cam_center_new) / torch.clamp(mp_dist, min=1e-12)[..., None]
    cos_view = (vdir * ms.mp_normal).sum(-1)
    cand = (
        ms.mp_valid
        & ms.mp_good_prl        # no-parallax MPs have unreliable depth
        & ~already
        & (z > 0)
        & (u >= 0) & (u < cfg.width) & (v >= 0) & (v < cfg.height)
        & (mp_dist >= 0.8 * ms.mp_min_dist)
        & (mp_dist <= 1.2 * ms.mp_max_dist)
        & (cos_view > _COS_30)
    )
    feat_free = feats.valid & (obs_row < 0)
    proj_match, _n_proj = match_by_projection_streamed(
        feats, torch.stack([u, v], -1), ms.mp_main_octave, ms.mp_desc, cand, feat_free,
        level_offset=2,         # findCorrespd passes 2 (src/LocalMapper.cpp:118)
    )
    proj_ok = proj_match >= 0
    # fresh-triangulation acceptance gate (findCorrespd stage b,
    # src/LocalMapper.cpp:119-141; MapPoint::acceptNewObserve)
    mm = proj_match.clamp(min=0).long()
    main_kf_b = ms.mp_main_kf[mm].clamp(min=0).long()
    main_ft_b = ms.mp_main_feat[mm].clamp(min=0).long()
    pt_main = ms.kf_xy[main_kf_b, main_ft_b]
    Tcw_main = kf_Tcw(ms.kf_pose[main_kf_b], Tcb)
    x3d = triangulate(pt_main, feats.xy, Kmat @ Tcw_main[:, :3, :], (Kmat @ Tcw_new[:3, :])[None])
    pos_new_c = se3.apply(Tcw_new, x3d)
    pos_main_c = se3.apply(Tcw_main, x3d)
    dist_new = torch.linalg.norm(pos_new_c, dim=-1)
    tri_ok = (
        cfg.accept_depth(pos_new_c[..., 2])
        & cfg.accept_depth(pos_main_c[..., 2])
        & (dist_new >= ms.mp_min_dist[mm])
        & (dist_new <= ms.mp_max_dist[mm])
    )
    ms, proj_ok = _append_obs(ms, proj_match, k, arangeN, proj_ok & tri_ok)
    obs_row = torch.where(proj_ok, proj_match, obs_row)

    # ---- updateParallax: re-triangulate not-yet-good-parallax points from
    #      their oldest recent observer with the CURRENT pose estimates; on
    #      ≥2° parallax replace the position, promote, and back-fill every
    #      observer's view estimate (MapPoint::updateParallax,
    #      src/MapPoint.cpp:124-185) ----
    m_act = obs_row.clamp(min=0).long()
    act = (
        (obs_row >= 0)
        & ms.mp_valid[m_act]
        & ~ms.mp_good_prl[m_act]
        & (ms.mp_n_obs[m_act] > 2)
    )
    obs_k_act = ms.mp_obs_kf[m_act]         # (N, P) observers per feature
    obs_f_act = ms.mp_obs_feat[m_act]
    recent = (obs_k_act >= 0) & (k - obs_k_act <= 6) & (obs_k_act != k)
    kf0 = torch.where(recent, obs_k_act, K).amin(dim=1)
    has0 = kf0 < K
    sel0 = recent & (obs_k_act == kf0[:, None])
    f0 = torch.where(sel0, obs_f_act, -1).amax(dim=1)
    kf0c = kf0.clamp(0, K - 1).long()
    pt0 = ms.kf_xy[kf0c, f0.clamp(min=0).long()]
    Tcw0 = kf_Tcw(ms.kf_pose[kf0c], Tcb)
    posW = triangulate(pt0, feats.xy, Kmat @ Tcw0[:, :3, :], (Kmat @ Tcw_new[:3, :])[None])
    pos0_c = se3.apply(Tcw0, posW)
    pos1_c = se3.apply(Tcw_new, posW)
    center0 = se3.inv(Tcw0)[:, :3, 3]
    prom = (
        act
        & has0
        & cfg.accept_depth(pos0_c[..., 2])
        & cfg.accept_depth(pos1_c[..., 2])
        & check_parallax(center0, cam_center_new, posW, 2)
    )
    rows_p = torch.where(prom, m_act, M)
    ms = ms._replace(
        mp_pos=_scatter(ms.mp_pos, rows_p, posW),
        mp_good_prl=_scatter(ms.mp_good_prl, rows_p, True),
    )
    # observer view back-fill: the (pos0, Tcw0, Tcw_new) anisotropic info
    # rotated world-wise, then into each observer's camera frame
    # (src/MapPoint.cpp:158-177)
    info0, _info1 = factors.se3_to_xyz_info(pos0_c, Tcw0, Tcw_new, cfg.fx)
    R0 = Tcw0[:, :3, :3]
    infoW = torch.einsum("nji,njm,nml->nil", R0, info0, R0)
    Tcw_all = kf_Tcw(ms.kf_pose, Tcb)
    sel_obs = prom[:, None] & (obs_k_act >= 0)
    T_obs = Tcw_all[obs_k_act.clamp(min=0).long()]          # (N, P, 4, 4)
    view_obs = se3.apply(T_obs, posW[:, None, :])
    Rk_obs = T_obs[..., :3, :3]
    info_obs = torch.einsum("npij,njm,nplm->npil", Rk_obs, infoW, Rk_obs)
    rk = torch.where(sel_obs, obs_k_act, K)
    rf = obs_f_act.clamp(min=0)
    ms = ms._replace(
        kf_view_mp=_scatter(ms.kf_view_mp, (rk, rf), view_obs),
        kf_view_info=_scatter(ms.kf_view_info, (rk, rf), info_obs),
    )

    # ---- finalize the new KF's observation row + view estimates ----
    has_obs = obs_row >= 0
    oc = obs_row.clamp(min=0).long()
    view_c = se3.apply(Tcw_new, ms.mp_pos[oc])
    info_new, _ = factors.se3_to_xyz_info(view_c, Tcw_new, Tcw_ref, cfg.fx)
    ms = ms._replace(
        kf_obs_mp=_put_row(ms.kf_obs_mp, k, obs_row),
        kf_view_mp=_put_row(ms.kf_view_mp, k, torch.where(
            has_obs[:, None], view_c, torch.zeros_like(view_c))),
        kf_view_info=_put_row(ms.kf_view_info, k, torch.where(
            has_obs[:, None, None], info_new, torch.zeros_like(info_new))),
    )

    # ---- map-point maintenance for every observation this KF adds: bit
    #      votes → majority descriptor, running-mean viewing normal
    #      (src/MapPoint.cpp:104-122, 228-292) ----
    vote_rows = torch.where(has_obs, obs_row, M)
    votes = _scatter(ms.mp_desc_votes, vote_rows, feats.desc_pm1.to(torch.int16),
                     accumulate=True)
    touched = _scatter(no_mp, vote_rows, True)
    majority = torch.where(votes >= 0, 1, -1).to(torch.int8)
    new_desc = torch.where(touched[:, None], majority, ms.mp_desc)

    obs_dir = ms.mp_pos[oc] - cam_center_new
    obs_dir = obs_dir / torch.clamp(torch.linalg.norm(obs_dir, dim=-1, keepdim=True), min=1e-12)
    w_old = torch.clamp(ms.mp_n_obs[oc].to(dtype) - 1.0, min=1.0)
    blended = ms.mp_normal[oc] * w_old[:, None] + obs_dir
    blended = blended / torch.clamp(torch.linalg.norm(blended, dim=-1, keepdim=True), min=1e-12)
    ms = ms._replace(mp_desc_votes=votes, mp_desc=new_desc,
                     mp_normal=_scatter(ms.mp_normal, vote_rows, blended))

    # ---- covisibility (>30% shared MPs, Map::updateCovisibility,
    #      src/Map.cpp:785-799), counted from the inverse lists ----
    seen_new = _scatter(no_mp, vote_rows, True)
    cnt_sel = (ms.mp_obs_kf >= 0) & seen_new[:, None]
    shared = _scatter(torch.zeros((K,), dtype=_I32, device=dev),
                      torch.where(cnt_sel, ms.mp_obs_kf, K).reshape(-1), 1, accumulate=True)
    count_other = (ms.kf_obs_mp >= 0).sum(1)
    count_new = has_obs.sum()
    ratio = shared.to(dtype) / torch.clamp(torch.minimum(count_other, count_new), min=1).to(dtype)
    arangeK = torch.arange(K, device=dev)
    covis_new = (ratio > 0.3) & ms.kf_valid & (arangeK != k) & (shared > 0)
    covis = _put_row(ms.covis, k, covis_new)
    covis.index_put_((arangeK, _idx(k, dev).expand(K)), covis_new)
    ms = ms._replace(covis=covis)

    # ---- odometry chain with preintegration (KeyFrame::preOdomFromSelf,
    #      src/LocalMapper.cpp:70-76) ----
    ms = ms._replace(
        kf_pre_next=_put_row(ms.kf_pre_next, ref_kf, k),
        kf_pre_meas=_put_row(ms.kf_pre_meas, ref_kf, pre_meas),
        kf_pre_cov=_put_row(ms.kf_pre_cov, ref_kf, pre_cov),
    )

    # ---- cull MPs with no parallax after 6 KFs (MapPoint::updateParallax
    #      kill rule, src/MapPoint.cpp:181-184), unlinking them from every
    #      keyframe's forward table ----
    stale = ms.mp_valid & ~ms.mp_good_prl & (k - ms.mp_main_kf > 6)
    fw_stale = _fw_mask_from_inverse(K, N, ms.mp_obs_kf, ms.mp_obs_feat, stale)
    ms = ms._replace(
        mp_valid=ms.mp_valid & ~stale,
        kf_obs_mp=torch.where(fw_stale, -1, ms.kf_obs_mp),
        n_kf=ms.n_kf + 1,
    )

    # capacity guard: a full KF bank drops the insertion atomically
    full = ms_in.n_kf >= K
    return _where_state(full, ms_in, ms), torch.where(full, -1, k)


def prune_redundant_kf(ms: MapState, cur_kf, protect=-1, *, cfg: SystemConfig,
                       min_ratio=0.8):
    """Remove at most one redundant keyframe (Map::pruneRedundantKF,
    src/Map.cpp:146-283): one whose observed map points are ≥ ``min_ratio``
    seen by at least 2 other keyframes. Its two odometry edges are spliced
    into one composed preintegration, its observations leave every map
    point's list, points left with < 2 observers die, and points anchored
    on it are re-anchored with fresh scale gates.
    Returns (MapState, pruned slot or -1)."""
    K, M, N = ms.K, ms.M, ms.N
    P = ms.mp_obs_kf.shape[1]
    dev = ms.kf_pose.device
    arangeK = torch.arange(K, device=dev)
    cur_kf = torch.as_tensor(cur_kf, device=dev)
    protect = torch.as_tensor(protect, device=dev)

    # per-KF redundancy score from the inverse lists (valid points only:
    # a culled point's inverse row is stale)
    n_mp_kf = (ms.kf_obs_mp >= 0).sum(1)
    ws_sel = (ms.mp_obs_kf >= 0) & (ms.mp_valid & (ms.mp_n_obs >= 3))[:, None]
    well_count = _scatter(torch.zeros((K,), dtype=_I32, device=dev),
                          torch.where(ws_sel, ms.mp_obs_kf, K).reshape(-1), 1, accumulate=True)
    ratio = well_count / torch.clamp(n_mp_kf, min=1)

    # interior to the odometry chain, not the current/first two KFs
    has_next = ms.kf_pre_next >= 0
    prev_of = _scatter(torch.full((K,), -1, dtype=_I32, device=dev),
                       torch.where(has_next, ms.kf_pre_next, K), arangeK.to(_I32))
    # endpoints of loop/feature constraints are not prunable
    # (`!bHasFeatEdge`, src/Map.cpp:205-208) except under capacity pressure
    no_kf = torch.zeros((K,), dtype=torch.bool, device=dev)
    ftr_endpoint = _scatter(_scatter(no_kf, torch.where(ms.ftr_valid, ms.ftr_i, K), True),
                            torch.where(ms.ftr_valid, ms.ftr_j, K), True)
    escape = min_ratio <= 0.0
    candidate = (
        ms.kf_valid
        & (ratio >= min_ratio)
        & ((n_mp_kf > 0) | escape)
        & has_next
        & (prev_of >= 0)
        & (~ftr_endpoint | escape)
        & ((arangeK > 1) | escape)     # `mIdKF <= 1` protected, src/Map.cpp:171
        & (arangeK != cur_kf)
        & (arangeK != protect)
    )
    any_cand = candidate.any()
    # lowest-id candidate (reference scans in id order, src/Map.cpp:151)
    kid = torch.argmax(torch.where(candidate, K - arangeK, 0))
    kid_c = torch.where(any_cand, kid, 0)

    prev = _row(prev_of, kid_c).clamp(min=0)
    nxt = _row(ms.kf_pre_next, kid_c).clamp(min=0)

    # splice the odometry chain with composed preintegration
    new_meas, new_cov = factors.compose_preintegration(
        _row(ms.kf_pre_meas, prev), _row(ms.kf_pre_cov, prev),
        _row(ms.kf_pre_meas, kid_c), _row(ms.kf_pre_cov, kid_c),
    )
    pre_next = _put_row(_put_row(ms.kf_pre_next, prev, nxt), kid_c, -1)
    pre_meas = _put_row(ms.kf_pre_meas, prev, new_meas)
    pre_cov = _put_row(ms.kf_pre_cov, prev, new_cov)

    # remove the KF's observations from MP lists: compact each list with
    # entries of kid pushed out (stable within the fan-in P)
    hit = ms.mp_obs_kf == kid_c
    keep = ~hit & (ms.mp_obs_kf >= 0)
    iota = torch.arange(P, dtype=_I32, device=dev).expand(M, P)
    order = torch.argsort(torch.where(keep, 0, 1) * P + iota, dim=1, stable=True)
    obs_kf_new = torch.gather(torch.where(keep, ms.mp_obs_kf, -1), 1, order)
    obs_ft_new = torch.gather(torch.where(keep, ms.mp_obs_feat, -1), 1, order)
    n_obs_new = (obs_kf_new >= 0).sum(1, dtype=_I32)

    # main-KF reassignment for MPs anchored at the pruned KF
    was_main = ms.mp_main_kf == kid_c
    new_main_kf = torch.where(was_main, obs_kf_new[:, 0], ms.mp_main_kf)
    new_main_ft = torch.where(was_main, obs_ft_new[:, 0], ms.mp_main_feat)
    alive = n_obs_new >= 2

    mk = new_main_kf.clamp(min=0).long()
    mf = new_main_ft.clamp(min=0).long()
    oct_at_new = ms.kf_octave[mk, mf]
    Tcb = constants(cfg, dev)["Tcb"]
    centers = se3.inv(kf_Tcw(ms.kf_pose, Tcb))[:, :3, 3]
    dist = torch.linalg.norm(ms.mp_pos - centers[mk], dim=-1)
    md, xd = _octave_dist_gates(oct_at_new, dist, cfg.scale_factor, cfg.max_level)
    refresh = was_main & (new_main_kf >= 0) & (new_main_ft >= 0)
    main_oct_new = torch.where(refresh, oct_at_new, ms.mp_main_octave)
    min_d_new = torch.where(refresh, md, ms.mp_min_dist)
    max_d_new = torch.where(refresh, xd, ms.mp_max_dist)

    # clear surviving keyframes' forward pointers at dead MPs
    mp_valid_new = ms.mp_valid & alive
    newly_dead = ms.mp_valid & ~alive
    dead_fw = _fw_mask_from_inverse(K, N, obs_kf_new, obs_ft_new, newly_dead)
    kf_obs_clean = torch.where(dead_fw, -1, ms.kf_obs_mp)

    covis = _put_row(ms.covis, kid_c, False)
    covis.index_put_((arangeK, _idx(kid_c, dev).expand(K)),
                     torch.zeros((), dtype=torch.bool, device=dev))
    pruned = ms._replace(
        kf_valid=_put_row(ms.kf_valid, kid_c, False),
        kf_feat_valid=_put_row(ms.kf_feat_valid, kid_c, False),
        kf_obs_mp=_put_row(kf_obs_clean, kid_c, -1),
        kf_pre_next=pre_next,
        kf_pre_meas=pre_meas,
        kf_pre_cov=pre_cov,
        covis=covis,
        # reachable only via the capacity escape hatch
        ftr_valid=ms.ftr_valid & (ms.ftr_i != kid_c) & (ms.ftr_j != kid_c),
        mp_valid=mp_valid_new,
        mp_main_kf=new_main_kf,
        mp_main_feat=new_main_ft,
        mp_main_octave=main_oct_new,
        mp_min_dist=min_d_new,
        mp_max_dist=max_d_new,
        mp_obs_kf=obs_kf_new,
        mp_obs_feat=obs_ft_new,
        mp_n_obs=n_obs_new,
    )
    return _where_state(any_cand, pruned, ms), torch.where(any_cand, kid_c, -1)


def recompute_covis(ms: MapState) -> MapState:
    """The whole covisibility matrix rebuilt from the inverse observation
    tables (>30% shared points, add_keyframe's criterion pairwise): shared
    = OᵀO over the (M, K) observer one-hot. For operations that rewire
    observations wholesale (map merging)."""
    K, M = ms.K, ms.M
    dev, dtype = ms.kf_pose.device, ms.kf_pose.dtype
    obs_ok = (ms.mp_obs_kf >= 0) & ms.mp_valid[:, None]
    O = torch.zeros((M, K), dtype=dtype, device=dev)
    rows = torch.arange(M, device=dev)[:, None].expand_as(ms.mp_obs_kf)
    O.index_put_((rows, ms.mp_obs_kf.clamp(min=0).long()), obs_ok.to(dtype), accumulate=True)
    O = torch.clamp(O, max=1.0)
    shared = O.T @ O                                    # (K, K), exact small integers
    counts = torch.diagonal(shared)
    min_c = torch.minimum(counts[:, None], counts[None, :])
    ratio = shared / torch.clamp(min_c, min=1.0)
    covis = ((ratio > 0.3) & (shared > 0) & ms.kf_valid[:, None] & ms.kf_valid[None, :]
             & ~torch.eye(K, dtype=torch.bool, device=dev))
    return ms._replace(covis=covis)


def cull_weak_mps(ms: MapState, n_keep, protect_kf):
    """Invalidate the weakest valid map points until ≤ ``n_keep`` live (the
    map-point side of capacity relief): fewest observers first,
    bad-parallax before good, oldest slot first among ties; points that
    ``protect_kf`` (the tracking reference) observes are never culled. Both
    observation tables are cleared for culled points.
    Returns (MapState, n_culled)."""
    M = ms.M
    dev = ms.mp_pos.device
    f32 = torch.float32
    ref_row = _row(ms.kf_obs_mp, protect_kf)
    obs_by_ref = _scatter(torch.zeros((M,), dtype=torch.bool, device=dev),
                          torch.where(ref_row >= 0, ref_row, M), True)
    score = ms.mp_n_obs.to(f32) + 16.0 * ms.mp_good_prl.to(f32) + 1e6 * obs_by_ref.to(f32)
    score = torch.where(ms.mp_valid, score, torch.full_like(score, float("inf")))
    n_valid = ms.mp_valid.sum(dtype=_I32)
    n_cull = torch.clamp(n_valid - torch.as_tensor(n_keep, dtype=_I32, device=dev), min=0)
    order = torch.argsort(score, stable=True)           # weakest first
    cull = torch.zeros((M,), dtype=torch.bool, device=dev)
    cull[order] = torch.arange(M, device=dev) < n_cull
    cull = cull & ms.mp_valid & ~obs_by_ref
    kf_obs = torch.where((ms.kf_obs_mp >= 0) & cull[ms.kf_obs_mp.clamp(min=0).long()],
                         -1, ms.kf_obs_mp)
    return ms._replace(
        mp_valid=ms.mp_valid & ~cull,
        kf_obs_mp=kf_obs,
        mp_obs_kf=torch.where(cull[:, None], -1, ms.mp_obs_kf),
        mp_obs_feat=torch.where(cull[:, None], -1, ms.mp_obs_feat),
        mp_n_obs=torch.where(cull, 0, ms.mp_n_obs),
    ), cull.sum(dtype=_I32)


def _compaction(valid):
    """(new slot of each old slot or -1, old slot of each new slot, live
    mask of the new slots, live count) for a validity mask."""
    n = valid.shape[0]
    dev = valid.device
    new = torch.where(valid, torch.cumsum(valid, 0, dtype=_I32) - 1, -1).to(_I32)
    n_new = valid.sum(dtype=_I32)
    old = _scatter(torch.zeros((n,), dtype=_I32, device=dev), torch.where(valid, new, n),
                   torch.arange(n, dtype=_I32, device=dev))
    return new, old.long(), torch.arange(n, device=dev) < n_new, n_new


def _gather_live(x, old, live, fill=0):
    """x[old] with the rows past the live count set to ``fill``."""
    return torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)), x[old],
                       torch.as_tensor(fill, dtype=x.dtype, device=x.device))


def _remap_ref(x, new):
    """Slot references through a compaction (-1 stays -1; dead refs die)."""
    return torch.where(x >= 0, new[x.clamp(min=0).long()], -1)


def _mp_gathered(ms: MapState, mp_old, mp_live, mp_main_kf, mp_obs_kf):
    """The map-point fields of a compaction (observation lists with their
    dead entries cleared and recounted)."""
    g = _gather_live
    obs_kf = g(mp_obs_kf, mp_old, mp_live, -1)
    obs_ok = obs_kf >= 0
    return dict(
        mp_pos=g(ms.mp_pos, mp_old, mp_live),
        mp_valid=mp_live,
        mp_good_prl=g(ms.mp_good_prl, mp_old, mp_live, False),
        mp_desc=g(ms.mp_desc, mp_old, mp_live),
        mp_desc_votes=g(ms.mp_desc_votes, mp_old, mp_live),
        mp_normal=g(ms.mp_normal, mp_old, mp_live),
        mp_main_kf=g(mp_main_kf, mp_old, mp_live, -1),
        mp_main_feat=g(ms.mp_main_feat, mp_old, mp_live, -1),
        mp_main_octave=g(ms.mp_main_octave, mp_old, mp_live),
        mp_min_dist=g(ms.mp_min_dist, mp_old, mp_live),
        mp_max_dist=g(ms.mp_max_dist, mp_old, mp_live, float("inf")),
        mp_obs_kf=obs_kf,
        mp_obs_feat=torch.where(obs_ok, g(ms.mp_obs_feat, mp_old, mp_live, -1), -1),
        mp_n_obs=obs_ok.sum(1, dtype=_I32),
    )


def compact_mps(ms: MapState) -> MapState:
    """Renumber only the map-point slots so the valid ones are contiguous
    from 0 (keyframes untouched; no host-side structure holds point slots)."""
    mp_new, mp_old, mp_live, n_mp = _compaction(ms.mp_valid)
    return ms._replace(kf_obs_mp=_remap_ref(ms.kf_obs_mp, mp_new), n_mp=n_mp,
                       **_mp_gathered(ms, mp_old, mp_live, ms.mp_main_kf, ms.mp_obs_kf))


def relieve_mp_pressure(ms: MapState, target, protect_kf):
    """The map-point pressure response: force-cull the weakest points to ≤
    ``target`` live (a no-op when holes alone suffice), then compact.
    Returns (MapState, n_culled)."""
    ms, n_culled = cull_weak_mps(ms, target, protect_kf)
    return compact_mps(ms), n_culled


def compact_map(ms: MapState):
    """Renumber keyframe and map-point slots so the valid entries are
    contiguous from 0, freeing the tail (the live-map form of the
    reference's save-time renumbering, MapStorage::saveMap,
    src/MapStorage.cpp:77-118). Returns (MapState, kf_new_of_old (K,),
    mp_new_of_old (M,)), -1 for dead slots."""
    kf_new, kf_old, kf_live, n_kf = _compaction(ms.kf_valid)
    mp_new, mp_old, mp_live, n_mp = _compaction(ms.mp_valid)
    g = _gather_live
    covis = ms.covis[kf_old][:, kf_old] & kf_live[:, None] & kf_live[None, :]
    out = ms._replace(
        kf_pose=g(ms.kf_pose, kf_old, kf_live),
        kf_odom=g(ms.kf_odom, kf_old, kf_live),
        kf_valid=kf_live,
        kf_xy=g(ms.kf_xy, kf_old, kf_live),
        kf_octave=g(ms.kf_octave, kf_old, kf_live),
        kf_angle=g(ms.kf_angle, kf_old, kf_live),
        kf_feat_valid=g(ms.kf_feat_valid, kf_old, kf_live, False),
        kf_desc=g(ms.kf_desc, kf_old, kf_live),
        kf_obs_mp=_remap_ref(g(ms.kf_obs_mp, kf_old, kf_live, -1), mp_new),
        kf_view_mp=g(ms.kf_view_mp, kf_old, kf_live),
        kf_view_info=g(ms.kf_view_info, kf_old, kf_live),
        kf_pre_next=_remap_ref(g(ms.kf_pre_next, kf_old, kf_live, -1), kf_new),
        kf_pre_meas=g(ms.kf_pre_meas, kf_old, kf_live),
        kf_pre_cov=g(ms.kf_pre_cov, kf_old, kf_live),
        covis=covis,
        ftr_i=_remap_ref(torch.where(ms.ftr_valid, ms.ftr_i, -1), kf_new),
        ftr_j=_remap_ref(torch.where(ms.ftr_valid, ms.ftr_j, -1), kf_new),
        ftr_valid=(ms.ftr_valid & (_remap_ref(ms.ftr_i, kf_new) >= 0)
                   & (_remap_ref(ms.ftr_j, kf_new) >= 0)),
        n_kf=n_kf,
        n_mp=n_mp,
        **_mp_gathered(ms, mp_old, mp_live, _remap_ref(ms.mp_main_kf, kf_new),
                       _remap_ref(ms.mp_obs_kf, kf_new)),
    )
    return out, kf_new, mp_new


def local_graph_masks(ms: MapState, cur_kf, hops: int = 3):
    """Multi-hop covisibility BFS from the current KF
    (Map::updateLocalGraph, src/Map.cpp:285-331; ``hops`` is the
    reference's searchLevel = 3). Odometry-chain links count as edges.

    Returns (local_kf_mask, ref_kf_mask, local_mp_mask): KFs within
    ``hops``, MPs observed by any local KF, and the other observers of
    local MPs (the fixed frontier)."""
    K = ms.K
    dev = ms.kf_pose.device
    rows = torch.arange(K, device=dev)
    nxt = ms.kf_pre_next
    has_nxt = nxt >= 0
    cols = nxt.clamp(min=0).long()
    adj = ms.covis.clone()
    adj[rows, cols] = adj[rows, cols] | has_nxt
    adj[cols, rows] = adj[cols, rows] | has_nxt

    v = _put_row(torch.zeros((K,), dtype=torch.bool, device=dev), cur_kf, True)
    for _ in range(hops):
        v = v | (adj & v[None, :]).any(dim=1)
    local_kfs = v & ms.kf_valid

    obs = ms.mp_obs_kf
    obs_ok = obs >= 0
    oc = obs.clamp(min=0)
    local_mps = (local_kfs[oc.long()] & obs_ok).any(dim=1) & ms.mp_valid
    seen = _scatter(torch.zeros((K,), dtype=_I32, device=dev), oc.reshape(-1),
                    (local_mps[:, None] & obs_ok).to(_I32).reshape(-1), accumulate=True)
    ref_kfs = (seen > 0) & ~local_kfs & ms.kf_valid
    return local_kfs, ref_kfs, local_mps


def obs_sigma_info(p_o, x_o, Tcw_o, octave_o, obs_valid, cfg: SystemConfig, cam):
    """Per-observation 2x2 information from the plane-motion-marginalized
    measurement covariance (src/Map.cpp:1024-1049): pyramid-level pixel
    sigma plus the marginalized rotation/z-translation terms (one sigma
    for both rotation directions, as the reference's formula reads only
    PLANEMOTION_XROT_INFO, src/Map.cpp:1043). Behind-camera or invalid
    observations get identity Sigma and leave the returned validity."""
    lc_o = se3.apply(Tcw_o, x_o)
    level_sigma2 = constants(cfg, p_o.device)["level_sigma2"]
    sigma2_uv = level_sigma2[octave_o.clamp(0, cfg.max_level - 1).long()]
    Sigma = factors.se2xyz_sigma(p_o, x_o, lc_o, cam, Tcw_o, sigma2_uv,
                                 1.0 / cfg.plane_motion_xrot_info,
                                 1.0 / cfg.plane_motion_z_info)
    safe = obs_valid & (lc_o[..., 2] > 1e-3)
    eye2 = torch.eye(2, dtype=p_o.dtype, device=p_o.device)
    Sigma = torch.where(safe[:, None, None], Sigma, eye2[None])
    return linalg.inv2x2(Sigma), safe


class LocalWindow(NamedTuple):
    prob: BAProblem
    win_kf: torch.Tensor    # (W,) map KF slot per window slot (garbage if invalid)
    win_mp: torch.Tensor    # (Mw,) map MP slot per window point slot
    kf_sel: torch.Tensor    # (W,) bool
    mp_sel: torch.Tensor    # (Mw,) bool


def build_local_ba(ms: MapState, cur_kf, cfg: SystemConfig) -> LocalWindow:
    """Assemble the SE2-XYZ local window problem (Map::loadLocalGraph,
    src/Map.cpp:891-1053): newest local KFs + lowest-id fixed RefKFs, the
    local MPs with the most observers, reprojection edges with
    marginalized plane-motion 2x2 info compacted to ``cap.local_obs``
    slots, preintegrated odometry edges along the KF chain."""
    K, M, N = ms.K, ms.M, ms.N
    dev, dtype = ms.kf_pose.device, ms.kf_pose.dtype
    Wl = min(cfg.cap.local_kfs, K)
    Wr = min(cfg.cap.local_ref_kfs, K)
    Mw = min(cfg.cap.local_mps, M)
    c = constants(cfg, dev)
    cam, Tcb = c["cam"], c["Tcb"]

    local_kfs, ref_kfs, local_mps = local_graph_masks(ms, cur_kf)

    # newest local KFs first (a sliding window; local KFs beyond Wl are
    # dropped, not demoted to the fixed frontier); lowest-id ref KFs
    idxf = torch.arange(K, dtype=dtype, device=dev)
    ninf = torch.full_like(idxf, -float("inf"))
    _, loc_ids = top_k(torch.where(local_kfs, idxf, ninf), Wl)
    _, ref_ids = top_k(torch.where(ref_kfs, -idxf, ninf), Wr)
    loc_sel = local_kfs[loc_ids]
    ref_sel = ref_kfs[ref_ids]
    win_kf = torch.cat([loc_ids, ref_ids]).to(_I32)        # (W,)
    wk = win_kf.long()
    kf_sel = torch.cat([loc_sel, ref_sel])
    W = Wl + Wr
    is_ref = torch.cat([torch.zeros((Wl,), dtype=torch.bool, device=dev),
                        torch.ones((Wr,), dtype=torch.bool, device=dev)])

    # gauge: fix RefKFs + the oldest (min-id) local KF (src/Map.cpp:914-925)
    min_local = torch.where(loc_sel, loc_ids, K).amin()
    fixed = is_ref | (win_kf == min_local)
    kf2win = _scatter(torch.full((K,), -1, dtype=_I32, device=dev),
                      torch.where(kf_sel, win_kf, K), torch.arange(W, dtype=_I32, device=dev))

    # ALL local MPs participate, without the parallax filter
    # (getAllObsMPs(checkPrl=false), src/Map.cpp:313-316)
    mp_score = torch.where(local_mps, ms.mp_n_obs.to(dtype), torch.full_like(ms.mp_pos[:, 0], -float("inf")))
    _, win_mp = top_k(mp_score, Mw)
    mp_sel = local_mps[win_mp]
    win_mp = win_mp.to(_I32)
    mp2win = _scatter(torch.full((M,), -1, dtype=_I32, device=dev),
                      torch.where(mp_sel, win_mp, M), torch.arange(Mw, dtype=_I32, device=dev))

    poses = ms.kf_pose[wk]
    points = ms.mp_pos[win_mp.long()]

    # observations: all (window KF, feature) pairs compacted to the fixed
    # budget cap.local_obs, valid entries first in index order
    obs_mp_raw = ms.kf_obs_mp[wk]                          # (W, N)
    obs_mpw = mp2win[obs_mp_raw.clamp(min=0).long()]       # (W, N) window idx
    struct_valid = (
        kf_sel[:, None] & (obs_mp_raw >= 0) & (obs_mpw >= 0) & ms.kf_feat_valid[wk]
    ).reshape(-1)
    O = min(cfg.cap.local_obs, W * N)
    _, sel = top_k(struct_valid.to(torch.float32), O)
    obs_valid = struct_valid[sel]
    obs_kf_idx = torch.arange(W, dtype=_I32, device=dev)[:, None].expand(W, N).reshape(-1)[sel]
    obs_mp_idx = obs_mpw.clamp(min=0).reshape(-1)[sel]
    obs_uv = ms.kf_xy[wk].reshape(-1, 2)[sel]
    octave_o = ms.kf_octave[wk].reshape(-1)[sel]

    Tcw_w = kf_Tcw(poses, Tcb)                             # (W, 4, 4)
    ok_, om_ = obs_kf_idx.long(), obs_mp_idx.long()
    obs_info, obs_valid = obs_sigma_info(poses[ok_], points[om_], Tcw_w[ok_],
                                         octave_o, obs_valid, cfg, cam)

    # odometry edges along the preintegration chain
    nxt = ms.kf_pre_next[wk]
    e_j = kf2win[nxt.clamp(min=0).long()]
    e_valid = kf_sel & (nxt >= 0) & (e_j >= 0)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    cov_safe = torch.where(e_valid[:, None, None], ms.kf_pre_cov[wk] + 1e-10 * eye3[None], eye3[None])
    prob = BAProblem(
        poses=poses,
        points=points,
        pose_valid=kf_sel,
        pose_fixed=fixed,
        point_valid=mp_sel,
        obs_kf=obs_kf_idx,
        obs_mp=obs_mp_idx,
        obs_uv=obs_uv,
        obs_info=obs_info,
        obs_valid=obs_valid,
        edge_i=torch.arange(W, dtype=_I32, device=dev),
        edge_j=e_j.clamp(min=0),
        edge_meas=ms.kf_pre_meas[wk],
        edge_info=linalg.inv3x3(cov_safe),
        edge_valid=e_valid,
    )
    return LocalWindow(prob, win_kf, win_mp, kf_sel, mp_sel)


def run_local_ba(ms: MapState, cur_kf, cfg: SystemConfig):
    """Local BA + write-back (LocalMapper::localBA + Map::optimizeLocalGraph,
    src/LocalMapper.cpp:232-302, src/Map.cpp:754-783). Returns
    (MapState, info)."""
    c = constants(cfg, ms.kf_pose.device)
    win = build_local_ba(ms, cur_kf, cfg)
    ba_cfg = BAConfig(iters=cfg.local_iter, huber_delta=float(cfg.th_huber2) ** 0.5)
    poses, points, info = solve_local_ba(win.prob, c["cam"], c["Tcb"], ba_cfg)
    free = win.kf_sel & ~win.prob.pose_fixed
    return ms._replace(
        kf_pose=_scatter(ms.kf_pose, torch.where(free, win.win_kf, ms.K), poses),
        mp_pos=_scatter(ms.mp_pos, torch.where(win.mp_sel, win.win_mp, ms.M), points),
    ), info


def local_obs_chi2(ms: MapState, cur_kf, cfg: SystemConfig):
    """(has, chi2), each (K, N): which forward observations belong to the
    local window of ``cur_kf`` (``local_graph_masks``), and the unweighted
    pixel chi2 of every (keyframe, feature) observation."""
    K, N = ms.K, ms.N
    c = constants(cfg, ms.kf_pose.device)
    local_kfs, _, _ = local_graph_masks(ms, cur_kf)
    m = ms.kf_obs_mp
    pts = ms.mp_pos[m.clamp(min=0).long()]                   # (K, N, 3)
    poses = ms.kf_pose[:, None, :].expand(K, N, 3)
    r = factors.se2xyz_residual(poses, pts, ms.kf_xy, c["cam"], c["Tcb"])
    return (m >= 0) & local_kfs[:, None], (r * r).sum(-1)


def remove_outlier_obs(ms: MapState, cur_kf, cfg: SystemConfig):
    """Demote the local window's observations whose pixel chi2 exceeds
    th_huber2, and kill the map points left with fewer than 2
    observations (LocalMapper::removeOutlierChi2 + Map::
    removeLocalOutlierMP, src/LocalMapper.cpp:172-230, src/Map.cpp:700-752).
    As in the JAX package and the reference, which comments it out of the
    run loop (src/LocalMapper.cpp:329), no default path calls it.
    Returns (MapState, n_bad)."""
    M, P = ms.M, ms.mp_obs_kf.shape[1]
    dev = ms.kf_pose.device
    has, chi2 = local_obs_chi2(ms, cur_kf, cfg)
    bad = has & (chi2 > cfg.th_huber2)
    m = ms.kf_obs_mp
    new_obs = torch.where(bad, -1, m)

    # compact the inverse lists: entries whose forward pointer still
    # names the point first, in slot order (the key is unique in a row,
    # so the sort is exact)
    okf, oft = ms.mp_obs_kf.clamp(min=0).long(), ms.mp_obs_feat.clamp(min=0).long()
    rows = torch.arange(M, dtype=m.dtype, device=dev)[:, None]
    fwd_ok = (new_obs[okf, oft] == rows) & (ms.mp_obs_kf >= 0)
    key = (~fwd_ok).to(torch.int32) * P + torch.arange(P, dtype=torch.int32, device=dev)[None]
    order = torch.argsort(key, dim=1)
    obs_kf = torch.where(fwd_ok, ms.mp_obs_kf, -1).gather(1, order)
    obs_ft = torch.where(fwd_ok, ms.mp_obs_feat, -1).gather(1, order)
    n_obs = (obs_kf >= 0).sum(1, dtype=_I32)
    new_valid = ms.mp_valid & (n_obs >= 2)
    # a killed point's surviving forward pointers are cleared too, or its
    # feature slots stay blocked (prune_redundant_kf does the same)
    fwd = torch.where((new_obs >= 0) & ~new_valid[new_obs.clamp(min=0).long()], -1, new_obs)
    return ms._replace(
        kf_obs_mp=fwd,
        mp_obs_kf=obs_kf,
        mp_obs_feat=obs_ft,
        mp_n_obs=n_obs,
        mp_valid=new_valid,
    ), bad.sum(dtype=_I32)
