"""Cross-map merging: align and fuse two independently built maps (port of
se2lam_tpu.mapmerge; the reference has no analog, its MapStorage holds one
map, src/MapStorage.cpp).

Robots map parts of an environment independently, each in its own gauge;
``merge_maps`` welds map B into map A's frame and capacity layout, and a
``Localizer`` or the fleet localizer then serves on the union:

1. compact both maps (``localmap.compact_map``);
2. cross-map place recognition: one vocabulary trained on the union of
   both maps' descriptors, every B keyframe BoW-scored against A's bank;
3. alignment: B's keyframe relocalizes against A's (mutual descriptor
   match + RANSAC, ``localizer._relocalize_verify``), then a pose-only
   solve on A's fixed map points seeded at A's candidate pose;
4. the rigid SE(2) transform of map B into A's frame;
5. slot concatenation with every cross-table index offset;
6. the loop-closing machinery welds the seam: verification, the pose-only
   constraint, a feature edge, duplicate map-point fusion, the covisibility
   rebuilt from the observation tables, the pose-graph GBA and the joint
   GBA (the Schur kernel at the bank's (max_kfs, max_mps)).

Every function takes and returns ``MapState``s without writing an input in
place. ``merge_maps`` is the host orchestrator: a candidate pair is tried
only after the previous one failed a gate read back to the host.

Draws: one ``torch.Generator`` (seeded 42 on the device when not given)
gives, in this order, the vocabulary's seed rows, each alignment's RANSAC
noise and each seam verification's. The JAX package splits its key into
three instead; the parity tests pass its draws in per stage (``seed_idx``,
``align_gumbel``, ``verify_gumbel``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import vocab as vocab_mod
from .config import SystemConfig
from .device import resolve_device
from .localizer import _relocalize_verify
from .localmap import compact_map, recompute_covis
from .loopclose import (
    add_ftr_edge, build_loop_constraint, kf_features, merge_loop_mps, run_global_ba,
    run_global_ba_joint, verify_loop,
)
from .mapstate import MapState
from .ops import se2
from .ops.topk import top_k as _top_k
from .solver.poseonly import solve_pose_only
from .tracking import constants

__all__ = ["find_cross_pair", "align_transform", "transform_map", "concat_maps",
           "merge_maps", "merge_many"]

_I32 = torch.int32


def _check_layouts(ms_a: MapState, ms_b: MapState):
    """A clear error when the two maps' feature layouts differ (feature
    slots N, observation fan-in P, descriptor width): a mismatch would
    otherwise fail as a shape error deep in vocabulary training or the
    concatenation."""
    probes = (
        ("features per KF (Capacity.n_features)", ms_a.N, ms_b.N),
        ("obs fan-in (Capacity.max_obs_per_mp)", ms_a.mp_obs_kf.shape[1],
         ms_b.mp_obs_kf.shape[1]),
        ("descriptor width", ms_a.kf_desc.shape[-1], ms_b.kf_desc.shape[-1]),
    )
    for name, a, b in probes:
        if a != b:
            raise ValueError(f"map layouts differ in {name}: {a} vs {b} — both maps "
                             "must be built with the same Capacity feature layout")


def _to_device(ms: MapState, dev: torch.device) -> MapState:
    return MapState(*(t.to(dev) for t in ms))


def _kf_bank(vocab, ms: MapState):
    return vocab_mod.bow_transform(vocab, ms.kf_desc,
                                   ms.kf_feat_valid & ms.kf_valid[:, None])[0]


def find_cross_pair(ms_a: MapState, ms_b: MapState, vocab=None, n_words: int = 512,
                    generator: torch.Generator | None = None, top_k: int = 5, *,
                    seed_idx=None):
    """Top cross-map keyframe pairs by BoW score: (pairs, vocab) with
    ``pairs`` a score-descending list of (ka, kb, score), finite scores
    only, ties in ``lax.top_k``'s order (lower flat index first). They are
    candidates: the best pair can fail geometric verification while a
    runner-up passes (the Localizer's top-3 relocalization,
    src/Localizer.cpp:337-392). Without ``vocab`` one is trained on the
    union of both maps' descriptors (one document per keyframe), its seed
    rows from ``generator`` or given as ``seed_idx``."""
    _check_layouts(ms_a, ms_b)
    dev = ms_a.kf_pose.device
    if vocab is None:
        Ka, Kb, N = ms_a.K, ms_b.K, ms_a.N
        desc = torch.cat([ms_a.kf_desc.reshape(-1, 256), ms_b.kf_desc.reshape(-1, 256)])
        valid = torch.cat([(ms_a.kf_feat_valid & ms_a.kf_valid[:, None]).reshape(-1),
                           (ms_b.kf_feat_valid & ms_b.kf_valid[:, None]).reshape(-1)])
        doc_ids = torch.cat([
            torch.arange(Ka, dtype=_I32, device=dev).repeat_interleave(N),
            torch.arange(Kb, dtype=_I32, device=dev).repeat_interleave(N) + Ka,
        ])
        if seed_idx is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        vocab = vocab_mod.train_vocab(desc, valid, n_words=n_words, generator=generator,
                                      seed_idx=seed_idx, doc_ids=doc_ids, n_docs_cap=Ka + Kb)
    bank_a = _kf_bank(vocab, ms_a)                       # (Ka, W)
    bank_b = _kf_bank(vocab, ms_b)                       # (Kb, W)
    # bow_score carries the all-zero-vector guard (an unmasked empty row
    # would score 0.5 against any query, above every gate)
    scores = torch.vmap(lambda v: vocab_mod.bow_score(bank_a, v))(bank_b)
    scores = torch.where(ms_b.kf_valid[:, None] & ms_a.kf_valid[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    top_s, top_i = _top_k(scores.reshape(-1), top_k)
    Ka = scores.shape[1]
    top_s, top_i = top_s.cpu().numpy(), top_i.cpu().numpy()
    pairs = [(int(i) % Ka, int(i) // Ka, float(s))
             for s, i in zip(top_s, top_i) if np.isfinite(s)]
    return pairs, vocab


def align_transform(ms_a: MapState, ka: int, ms_b: MapState, kb: int, cfg: SystemConfig,
                    generator: torch.Generator | None = None, min_inliers: int = 15, *,
                    gumbel=None):
    """The SE(2) transform T with ``compose(T, pose_b)`` in A's world frame.

    B's keyframe ``kb`` relocalizes against A's keyframe ``ka``: descriptor
    match + RANSAC (noise from ``generator``, or ``gumbel`` (n_trials, N))
    for 2D-3D correspondences, then a 30-step pose-only solve on A's fixed
    map points seeded at A's candidate pose. Returns (T (3,), n_inliers),
    or (None, n) when too few inliers survive either step."""
    dev = ms_a.kf_pose.device
    c = constants(cfg, dev)
    feats_b = kf_features(ms_b, kb)
    n_in, mp_idx, uv, pair = _relocalize_verify(
        ms_a, ka, feats_b, n_trials=cfg.cap.ransac_trials, generator=generator,
        gumbel=None if gumbel is None else torch.as_tensor(gumbel, device=dev))
    if int(n_in) < min_inliers:
        return None, int(n_in)
    pose_in_a, _chi, n_solve = solve_pose_only(
        ms_a.kf_pose[ka], ms_a.mp_pos[mp_idx.long()], uv, pair, c["cam"], c["Tcb"],
        iters=30, huber_delta=float(cfg.th_huber2) ** 0.5)
    if int(n_solve) < min_inliers:
        return None, int(n_solve)
    return se2.compose(pose_in_a, se2.inv(ms_b.kf_pose[kb])), int(n_solve)


def transform_map(ms: MapState, T) -> MapState:
    """The rigid SE(2) transform of a whole map: keyframe poses composed
    with T, map-point xy rotated and translated (z is height, unchanged),
    viewing normals rotated. Relative quantities (preintegration,
    feature-edge measurements, camera-frame view estimates, raw odometry)
    are frame-internal and untouched."""
    T = torch.as_tensor(T, dtype=ms.kf_pose.dtype, device=ms.kf_pose.device)
    R = se2.rot2(T[2])
    new_pose = torch.where(ms.kf_valid[:, None], se2.compose(T, ms.kf_pose), ms.kf_pose)
    xy = ms.mp_pos[:, :2] @ R.T + T[:2]
    new_mp = torch.where(ms.mp_valid[:, None], torch.cat([xy, ms.mp_pos[:, 2:]], -1),
                         ms.mp_pos)
    nxy = ms.mp_normal[:, :2] @ R.T
    return ms._replace(kf_pose=new_pose, mp_pos=new_mp,
                       mp_normal=torch.cat([nxy, ms.mp_normal[:, 2:]], -1))


def concat_maps(ms_a: MapState, ms_b: MapState) -> MapState:
    """Concatenate two COMPACTED maps into A's capacity layout.

    B's keyframes land in slots [n_kf_a, n_kf_a + n_kf_b), its map points
    in [n_mp_a, n_mp_a + n_mp_b); every cross-table index (observation
    tables, odometry chain, main-KF anchors, covisibility, feature edges)
    is offset accordingly, -1 staying -1. Raises ValueError when the union
    exceeds A's capacities or its feature-edge table."""
    _check_layouts(ms_a, ms_b)
    dev = ms_a.kf_pose.device
    na, nb, ma, mb, fa, fb = (int(x) for x in torch.stack([
        ms_a.n_kf, ms_b.n_kf, ms_a.n_mp, ms_b.n_mp,
        ms_a.ftr_valid.sum(dtype=_I32), ms_b.ftr_valid.sum(dtype=_I32)]).cpu())
    K, M = ms_a.K, ms_a.M
    if na + nb > K or ma + mb > M:
        raise ValueError(f"concat_maps: union ({na}+{nb} KFs, {ma}+{mb} MPs) exceeds "
                         f"capacity (K={K}, M={M}); prune or enlarge Capacity")
    F = ms_a.ftr_i.shape[0]
    if fa + fb > F:
        raise ValueError("concat_maps: feature-edge table overflow")

    def rows(n_out, n0, n, n_src):
        """(source row, from-B mask): output rows [n0, n0 + n) take B's
        rows [0, n); the source index is clamped as JAX's gather clamps."""
        idx = torch.arange(n_out, device=dev)
        return (idx - n0).clamp(0, n_src - 1), (idx >= n0) & (idx < n0 + n)

    kf_src, kf_b = rows(K, na, nb, ms_b.K)
    mp_src, mp_b = rows(M, ma, mb, ms_b.M)

    def cat(xa, xb, src, from_b):
        return torch.where(from_b.reshape((-1,) + (1,) * (xa.dim() - 1)), xb[src], xa)

    def cat_kf(xa, xb):
        return cat(xa, xb, kf_src, kf_b)

    def cat_mp(xa, xb):
        return cat(xa, xb, mp_src, mp_b)

    def off(x, n):      # B values that are slots: offset, -1 kept
        return torch.where(x >= 0, x + n, -1).to(x.dtype)

    # covisibility: block diagonal
    covis = ms_a.covis | (ms_b.covis[kf_src][:, kf_src] & kf_b[:, None] & kf_b[None, :])

    # feature edges: A's valid rows first, B's (offset) after, in slot order
    ftr = [ms_a.ftr_valid, ms_b.ftr_valid, ms_a.ftr_i, ms_b.ftr_i, ms_a.ftr_j, ms_b.ftr_j,
           ms_a.ftr_meas, ms_b.ftr_meas, ms_a.ftr_info, ms_b.ftr_info]
    va, vb, ia, ib, ja, jb, mea, meb, ifa, ifb = (t.cpu().numpy() for t in ftr)
    sa, sb = np.nonzero(va)[0], np.nonzero(vb)[0]
    ftr_i = np.full(F, -1, np.int32)
    ftr_j = np.full(F, -1, np.int32)
    ftr_meas = np.zeros((F, 3), np.float32)
    ftr_info = np.zeros((F, 3, 3), np.float32)
    ftr_i[:fa + fb] = np.concatenate([ia[sa], ib[sb] + na])
    ftr_j[:fa + fb] = np.concatenate([ja[sa], jb[sb] + na])
    ftr_meas[:fa + fb] = np.concatenate([mea[sa], meb[sb]])
    ftr_info[:fa + fb] = np.concatenate([ifa[sa], ifb[sb]])

    def t(a):
        return torch.from_numpy(a).to(dev)

    return ms_a._replace(
        kf_pose=cat_kf(ms_a.kf_pose, ms_b.kf_pose),
        kf_odom=cat_kf(ms_a.kf_odom, ms_b.kf_odom),
        kf_valid=cat_kf(ms_a.kf_valid, ms_b.kf_valid),
        kf_xy=cat_kf(ms_a.kf_xy, ms_b.kf_xy),
        kf_octave=cat_kf(ms_a.kf_octave, ms_b.kf_octave),
        kf_angle=cat_kf(ms_a.kf_angle, ms_b.kf_angle),
        kf_feat_valid=cat_kf(ms_a.kf_feat_valid, ms_b.kf_feat_valid),
        kf_desc=cat_kf(ms_a.kf_desc, ms_b.kf_desc),
        kf_obs_mp=cat_kf(ms_a.kf_obs_mp, off(ms_b.kf_obs_mp, ma)),
        kf_view_mp=cat_kf(ms_a.kf_view_mp, ms_b.kf_view_mp),
        kf_view_info=cat_kf(ms_a.kf_view_info, ms_b.kf_view_info),
        kf_pre_next=cat_kf(ms_a.kf_pre_next, off(ms_b.kf_pre_next, na)),
        kf_pre_meas=cat_kf(ms_a.kf_pre_meas, ms_b.kf_pre_meas),
        kf_pre_cov=cat_kf(ms_a.kf_pre_cov, ms_b.kf_pre_cov),
        covis=covis,
        ftr_i=t(ftr_i), ftr_j=t(ftr_j), ftr_meas=t(ftr_meas), ftr_info=t(ftr_info),
        ftr_valid=torch.arange(F, device=dev) < fa + fb,
        mp_pos=cat_mp(ms_a.mp_pos, ms_b.mp_pos),
        mp_valid=cat_mp(ms_a.mp_valid, ms_b.mp_valid),
        mp_good_prl=cat_mp(ms_a.mp_good_prl, ms_b.mp_good_prl),
        mp_desc=cat_mp(ms_a.mp_desc, ms_b.mp_desc),
        mp_desc_votes=cat_mp(ms_a.mp_desc_votes, ms_b.mp_desc_votes),
        mp_normal=cat_mp(ms_a.mp_normal, ms_b.mp_normal),
        mp_main_kf=cat_mp(ms_a.mp_main_kf, off(ms_b.mp_main_kf, na)),
        mp_main_feat=cat_mp(ms_a.mp_main_feat, ms_b.mp_main_feat),
        mp_main_octave=cat_mp(ms_a.mp_main_octave, ms_b.mp_main_octave),
        mp_min_dist=cat_mp(ms_a.mp_min_dist, ms_b.mp_min_dist),
        mp_max_dist=cat_mp(ms_a.mp_max_dist, ms_b.mp_max_dist),
        mp_obs_kf=cat_mp(ms_a.mp_obs_kf, off(ms_b.mp_obs_kf, na)),
        mp_obs_feat=cat_mp(ms_a.mp_obs_feat, ms_b.mp_obs_feat),
        mp_n_obs=cat_mp(ms_a.mp_n_obs, ms_b.mp_n_obs),
        n_kf=torch.tensor(na + nb, dtype=_I32, device=dev),
        n_mp=torch.tensor(ma + mb, dtype=_I32, device=dev),
    )


def merge_maps(ms_a: MapState, ms_b: MapState, cfg: SystemConfig,
               generator: torch.Generator | None = None, vocab=None, run_gba: bool = True, *,
               device=None, seed_idx=None, align_gumbel=None, verify_gumbel=None):
    """Merge map B into map A's frame and capacity layout, on ``device``
    (None means the card; both maps are moved there).

    Returns (merged MapState, info): the chosen keyframe pair (A's slot,
    B's compacted slot), its BoW score, the alignment and seam-verification
    counts, the seam edge's inliers, the duplicate map points fused, the
    GBAs' chi2 and the shared vocabulary (for a Localizer or LoopCloser on
    the merged map). Raises ValueError when no cross-map candidate passes
    every gate (the maps may not overlap).

    Draws from ``generator`` (seeded 42 on the device when not given), or
    per stage: ``seed_idx`` the vocabulary's seed rows, ``align_gumbel(ka,
    kb)`` a pair's alignment RANSAC noise, ``verify_gumbel`` the seam
    verification's (the same for every candidate, as in the JAX package)."""
    dev = resolve_device(device)
    ms_a, ms_b = _to_device(ms_a, dev), _to_device(ms_b, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(42)

    ms_a, _, _ = compact_map(ms_a)
    ms_b, _, _ = compact_map(ms_b)

    pairs, vocab = find_cross_pair(ms_a, ms_b, vocab, generator=generator, seed_idx=seed_idx)
    pairs = [p for p in pairs if p[2] >= cfg.gm_dcl_min_score_best]
    if not pairs:
        raise ValueError("merge_maps: no cross-map BoW score reaches the acceptance "
                         f"gate {cfg.gm_dcl_min_score_best} — no overlap?")

    # candidates in score order; each must pass the alignment solve AND the
    # LoopCloser's verification gates (gm_vcl_*) on the concatenated map
    # before anything is mutated: an unverified seam would fuse distinct
    # landmarks and bake the error in with a global BA
    na = int(ms_a.n_kf)
    tried = []
    for ka, kb, score in pairs:
        noise = (dict(generator=generator) if align_gumbel is None
                 else dict(gumbel=align_gumbel(ka, kb)))
        T, n_align = align_transform(ms_a, ka, ms_b, kb, cfg, **noise)
        if T is None:
            tried.append((ka, kb, f"{n_align} align inliers"))
            continue
        ms = concat_maps(ms_a, transform_map(ms_b, T))
        kb_m = kb + na                  # B's seam keyframe, merged slots
        noise = (dict(generator=generator) if verify_gumbel is None
                 else dict(gumbel=torch.as_tensor(verify_gumbel, device=dev)))
        match_idx, n_kp, n_mp_pairs, n_cur = verify_loop(
            ms, kb_m, ka, n_trials=cfg.cap.ransac_trials, **noise)
        n_kp, n_mp_pairs, n_cur = (int(x) for x in torch.stack([n_kp, n_mp_pairs, n_cur]).cpu())
        if (n_mp_pairs < cfg.gm_vcl_num_min_match_mp or n_kp < cfg.gm_vcl_num_min_match_kp
                or n_mp_pairs < cfg.gm_vcl_ratio_min_match_mp * max(n_cur, 1)):
            tried.append((ka, kb, f"verify {n_kp} kp / {n_mp_pairs} mp"))
            continue
        meas, cinfo, n_good, _good = build_loop_constraint(ms, kb_m, ka, match_idx, cfg)
        n_good = int(n_good)
        if n_good < cfg.gm_vcl_num_min_match_mp:
            tried.append((ka, kb, f"constraint {n_good} good"))
            continue

        # every gate passed: commit the weld. The edge runs cand → k, as
        # the LoopCloser orders it (ftr_meas is "j in i's frame")
        ms = add_ftr_edge(ms, ka, kb_m, meas, cinfo, evict_if_full=True)
        n_before = int(ms.mp_valid.sum())
        ms = merge_loop_mps(ms, kb_m, ka, match_idx)
        # fused landmarks make seam covisibility no insertion recorded:
        # rebuild it from the observation tables, so the local graph and
        # localization see across the seam
        ms = recompute_covis(ms)
        info = {
            "pair": (ka, kb), "bow_score": score, "align_inliers": n_align, "n_kp": n_kp,
            "n_mp_pairs": n_mp_pairs, "vocab": vocab,
            "mps_fused": n_before - int(ms.mp_valid.sum()), "seam_edge_inliers": n_good,
        }
        if run_gba:
            ms, gba_info = run_global_ba(ms, iters=cfg.global_iter)
            info["gba_chi2"] = float(gba_info["chi2"])
            if cfg.gm_joint_ba_iters > 0:
                # the joint reprojection polish every in-map closure gets
                # (the pose graph spreads only the one seam edge; the fused
                # co-observations hold the seam)
                ms, joint_info = run_global_ba_joint(ms, cfg, iters=cfg.gm_joint_ba_iters)
                info["joint_chi2"] = float(joint_info["chi2"])
        return ms, info

    raise ValueError("merge_maps: every cross-map candidate failed verification "
                     f"(pair, reason): {tried}")


def merge_many(maps, cfg: SystemConfig, generator: torch.Generator | None = None, *,
               device=None):
    """Left-fold ``merge_maps`` over a list of maps (an N-robot rendezvous),
    on ``device`` (None means the card), every step drawing from
    ``generator`` (seeded 7 when not given). Each step retrains the union
    vocabulary, so later maps score against words covering everything
    merged so far. Returns (merged, infos), one info dict per step, the
    vocabulary only in the last. The first map's frame wins; a map with no
    overlap against the running union raises, naming its position."""
    if len(maps) < 2:
        raise ValueError("merge_many needs at least two maps")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(7)
    ms, infos = maps[0], []
    for i, nxt in enumerate(maps[1:], start=1):
        try:
            ms, info = merge_maps(ms, nxt, cfg, generator=generator, device=dev)
        except ValueError as e:
            raise ValueError(f"merge_many: map #{i} failed: {e}") from e
        if i < len(maps) - 1:
            info.pop("vocab", None)   # only the final union vocabulary is kept
        infos.append(info)
    return ms, infos
