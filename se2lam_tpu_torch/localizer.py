"""Localization-only mode against a previously built map (port of
se2lam_tpu.localizer; reference Localizer thread, src/Localizer.cpp:32-176,
the LOCALIZATION_ONLY mode of src/OdoSLAM.cpp:120-132):

- tracked: the pose predicted by odometry from the last estimate
  (UpdatePoseCurr, :614-619), map points projected and matched
  (MatchLocalMap, :211-230), pose-only BA on the fixed points
  (DoLocalBA, :233-302), and the DetectIfLost gates (:304-313), with ONE
  host read a frame for the pose and the decision together;
- lost: BoW relocalization against the whole keyframe bank
  (DetectLoopClose, :337-392; score > 0.05), descriptor match + RANSAC
  verification (VerifyLoopClose, :394-431), the candidate's 2D-3D matches
  solved from its pose, then two projection-refinement rounds;
- the per-frame trajectory (WriteTrajFile, :178-193).

Projection matching runs against the FULL map-point bank through
``frontend.windowed_match.match_by_projection_streamed`` on every device:
kernel K2 on the card, its plain version on the CPU.

The relocalization RANSAC draws its noise from the Localizer's
``generator`` or, attempt by attempt, from ``reloc_gumbel``: None, or a
callable returning the next attempt's (ransac_trials, N) noise, with
which the parity tests replay the JAX package's key sequence.

Two more feeds give ``process``'s tracked flags and poses:

- ``process_chunk`` extracts k frames in one batched pass and localizes
  them with ``_localize_chunk`` (the tracked step over the frames, the
  accept gates on the device, the carry frozen by ``torch.where`` after
  the first frame that fails them) and ONE host read per tracked run; a
  lost frame goes to the per-frame relocalization. The steps after a
  loss still run on the device, since nothing reads the flag in between:
  ``frozen_steps`` counts them.
- ``process_async`` runs each frame's tracked step at once against the
  newest in-flight pose and reads it ``pipeline_depth`` frames later
  (``utils.prefetch``); an accepted frame's pose is its speculative
  step's, and a lost one relocalizes on the host and re-runs the frames in
  flight from there.

``host_reads`` counts the tracked path's decision reads (a frame, a chunk
run, a resolved frame); relocalization reads are not counted.
"""
from __future__ import annotations

import warnings
from collections import deque

import numpy as np
import torch

from . import tracking
from . import vocab as vocab_mod
from .config import SystemConfig
from .device import resolve_device
from .frontend.matcher import mutual_match
from .frontend.orb import OrbConfig, OrbExtractor, OrbFeatures
from .frontend.ransac import ransac_fundamental
from .frontend.windowed_match import match_by_projection_streamed
from .loopclose import kf_features
from .mapstate import MapState, kf_Tcw
from .ops import se2, se3
from .ops.camera import undistort_points
from .ops.topk import top_k
from .solver.poseonly import solve_pose_only
from .tracking import chunk_frame
from .utils.chunking import check_chunk, stack_images
from .utils.prefetch import host_prefetch
from .vocab import Vocabulary

__all__ = ["Localizer"]


def _project_and_match(ms: MapState, feats: OrbFeatures, pose, cfg: SystemConfig):
    """Project all valid map points into the view at ``pose`` and match
    them against the frame's features, the octave gate widened to ±2
    (MatchByProjection(..., 15, 2, ...), src/Localizer.cpp:217).
    Returns ((N,) int32 map point per feature or −1, () int32 count)."""
    Tcw = kf_Tcw(pose, tracking.constants(cfg, pose.device)["Tcb"])
    lc = se3.apply(Tcw, ms.mp_pos)
    z = lc[..., 2]
    z_safe = torch.where(z == 0, torch.ones_like(z), z)
    u = cfg.fx * lc[..., 0] / z_safe + cfg.cx
    v = cfg.fy * lc[..., 1] / z_safe + cfg.cy
    cand = (ms.mp_valid & (z > 0) & (u >= 0) & (u < cfg.width)
            & (v >= 0) & (v < cfg.height))
    return match_by_projection_streamed(
        feats, torch.stack([u, v], -1), ms.mp_main_octave, ms.mp_desc, cand,
        feats.valid, level_offset=2,
    )


def _covis_kf_count(ms: MapState, feat_match):
    """Number of valid keyframes observing any matched map point: the
    local covisible-keyframe set, whose emptiness means lost
    (Localizer::DetectIfLost, src/Localizer.cpp:304-313)."""
    K = ms.K
    sel = feat_match >= 0
    obs = ms.mp_obs_kf[feat_match.clamp(min=0).long()]          # (N, P)
    ok = sel[:, None] & (obs >= 0) & ms.kf_valid[obs.clamp(min=0).long()]
    idx = torch.where(ok, obs, torch.full_like(obs, K)).long().reshape(-1)
    # out of place, so that a vmap over robots can write batched indices
    seen = torch.zeros(K + 1, dtype=torch.bool, device=obs.device).scatter(0, idx, True)
    return seen[:K].sum(dtype=torch.int32)


def _localize_step(ms: MapState, pose, last_odom, feats: OrbFeatures, odo,
                   min_matches: int, cfg: SystemConfig):
    """One tracked localization step with the accept decision on the
    device: odometry prediction, projection match, pose-only solve, and
    the gates matches ≥ ``min_matches``, inliers ≥ ``min_matches``,
    covisible keyframes > 0. Returns (pose_out, ok); ``pose_out`` is the
    prediction when not ok. Reads nothing back to the host."""
    c = tracking.constants(cfg, pose.device)
    pred = se2.compose(pose, se2.minus(odo, last_odom))
    feat_match, n = _project_and_match(ms, feats, pred, cfg)
    m = feat_match.clamp(min=0).long()
    new_pose, _chi, n_in = solve_pose_only(
        pred, ms.mp_pos[m], feats.xy, feat_match >= 0, c["cam"], c["Tcb"], iters=30)
    n_covis = _covis_kf_count(ms, feat_match)
    ok = (n >= min_matches) & (n_in >= min_matches) & (n_covis > 0)
    return torch.where(ok, new_pose, pred), ok


def _localize_chunk(ms: MapState, pose0, last_odom0, feats_stack: OrbFeatures, odo_stack,
                    start: int, stop: int, min_matches: int, cfg: SystemConfig):
    """The tracked step over frames ``start..stop-1`` of a chunk (features
    with a leading chunk axis k, odometry (k, 3)), reading nothing back.
    The carry (pose, last odometry, lost) moves only where a frame passes
    the gates; after the first frame that fails them it is frozen by
    ``torch.where``, as the JAX package's ``lost`` flag freezes its scan, but
    the later steps still run. Returns ((k, 3) poses, (k,) tracked): the
    carried pose after each step (the start pose before ``start``)."""
    k = odo_stack.shape[0]
    pose, last = pose0, last_odom0
    lost = torch.zeros((), dtype=torch.bool, device=pose0.device)
    poses = [pose0] * k
    tracked = [lost] * k
    for i in range(start, stop):
        step_pose, ok = _localize_step(ms, pose, last, chunk_frame(feats_stack, i), odo_stack[i],
                                       min_matches, cfg)
        ok = ok & ~lost
        pose = torch.where(ok, step_pose, pose)
        last = torch.where(ok, odo_stack[i], last)
        lost = lost | ~ok
        poses[i], tracked[i] = pose, ok
    for i in range(stop, k):
        poses[i] = pose
    return torch.stack(poses), torch.stack(tracked)


def _relocalize_verify(ms: MapState, cand, feats: OrbFeatures, n_trials: int = 128, *,
                       generator: torch.Generator | None = None, gumbel=None):
    """Descriptor match + RANSAC inlier count against a candidate keyframe
    (Localizer::VerifyLoopClose, src/Localizer.cpp:394-431). Returns
    (n_inliers, mp_idx, uv, pair_valid): direct 2D-3D correspondences,
    the candidate's features with map points matched to current-frame
    pixels (the MatchLoopClose role, :433-454)."""
    f_kf = kf_features(ms, cand)
    midx = mutual_match(f_kf, feats, nn_ratio=0.9).idx2
    matched = midx >= 0
    cur_xy = feats.xy[midx.clamp(min=0).long()]
    fr = ransac_fundamental(
        f_kf.xy, cur_xy, matched, n_trials=n_trials, thresh_px=3.0, min_inliers=10,
        generator=generator, gumbel=gumbel,
    )
    # zero-baseline degeneracy: from (nearly) the mapped viewpoint the
    # correspondences determine no fundamental matrix and RANSAC rightly
    # fails; with tiny displacements the descriptor matches are kept as
    # they are, and the pose-only solve's inlier count judges them
    disp = torch.linalg.norm(cur_xy - f_kf.xy, dim=-1)
    disp_sorted = torch.sort(torch.where(matched, disp, torch.full_like(disp, float("inf")))).values
    n_matched = matched.sum(dtype=torch.int32)
    med = disp_sorted[torch.clamp(n_matched // 2, 0, disp.shape[0] - 1).long()]
    near_identical = (med < 2.0) & (n_matched >= 20)
    inliers = torch.where(near_identical, matched, fr.inliers)
    n_in = torch.where(near_identical, n_matched, fr.n_inliers)

    inl = torch.where(inliers, midx, torch.full_like(midx, -1))
    mp = ms.kf_obs_mp[cand]
    pair = (inl >= 0) & (mp >= 0) & ms.mp_valid[mp.clamp(min=0).long()]
    uv = feats.xy[inl.clamp(min=0).long()]
    return n_in, mp.clamp(min=0), uv, pair


class Localizer:
    """Host-driven localization loop over a loaded map::

        ms, vocab, _ = load_map(path)                 # the card
        loc = Localizer(cfg, ms, vocab)
        for img, odo in frames:
            pose = loc.process(img, odo)              # None while lost

    ``device=None`` means CUDA and raises without a card; the map and the
    vocabulary are moved to the device. The relocalization RANSAC draws
    from ``generator`` (seeded 7 when not given) or from ``reloc_gumbel``.
    """

    def __init__(
        self,
        cfg: SystemConfig,
        ms: MapState,
        vocab: Vocabulary | None = None,
        reloc_min_score: float = 0.05,
        reloc_min_inliers: int = 45,
        min_tracked_matches: int = 10,
        device=None,
        generator: torch.Generator | None = None,
    ):
        dev = self.device = resolve_device(device)
        self.cfg = cfg
        self.ms = MapState(*(t.to(dev) for t in ms))
        self.vocab = None if vocab is None else Vocabulary(*(t.to(dev) for t in vocab))
        self.reloc_min_score = reloc_min_score
        self.reloc_min_inliers = reloc_min_inliers
        self.min_tracked_matches = min_tracked_matches

        self.orb_cfg = OrbConfig(
            height=cfg.height, width=cfg.width, n_features=cfg.cap.n_features,
            scale_factor=cfg.scale_factor, n_levels=cfg.max_level,
        )
        self._extract = OrbExtractor(self.orb_cfg, device=dev)
        c = tracking.constants(cfg, dev)
        self._cam, self._Tcb = c["cam"], c["Tcb"]
        self._undistort = any(abs(d) > 0 for d in cfg.dist)

        if self.vocab is not None:
            ms_ = self.ms
            self.bank, _ = vocab_mod.bow_transform(
                self.vocab, ms_.kf_desc, ms_.kf_feat_valid & ms_.kf_valid[:, None])
        else:
            self.bank = None
            # without a vocabulary there is no relocalization path, so a
            # cold start can never localize: the caller must seed
            warnings.warn(
                "Localizer built without a vocabulary: call set_pose(pose, odo) to "
                "seed tracking, or pass the map's vocabulary to enable BoW "
                "relocalization.", stacklevel=2)

        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(7)
        self.generator = generator
        self.reloc_gumbel = None
        self.pose = None          # (3,) f32 last estimate; None until localized
        self.last_odom = None     # (3,) f32 on the device
        self.lost = True
        self.frame_id = 0
        self.trajectory: list[tuple[int, np.ndarray | None, bool]] = []
        self.host_reads = 0
        self.frozen_steps = 0
        # pipelined feed: in-flight [feats, odo, pose copy or None, ok, copy]
        self._pipe = deque()
        self.pipeline_depth = 4
        self._in_resolve = False

    def set_pose(self, pose, odo):
        """Seed the tracked state directly (a known start pose, or a map
        without a stored vocabulary)."""
        self.pose = np.asarray(pose, np.float32)
        self.last_odom = torch.as_tensor(np.asarray(odo, np.float32)).to(self.device)
        self.lost = False

    # -- public API --

    def extract(self, img) -> OrbFeatures:
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.asarray(img))
        feats = self._extract(img.to(self.device))
        if self._undistort:
            feats = feats._replace(xy=undistort_points(self._cam, feats.xy))
        return feats

    def process(self, img, odo) -> np.ndarray | None:
        """Localize one (image, odometry) pair: the body pose (3,) in the
        map's gauge, or None while lost."""
        return self.process_features(self.extract(img), odo)

    def process_features(self, feats: OrbFeatures, odo) -> np.ndarray | None:
        if self._pipe and not self._in_resolve:
            self._drain_pipe()   # a mixed-mode caller: frames stay in order
        dev = self.device
        odo = torch.as_tensor(odo, dtype=torch.float32).to(dev)

        if not self.lost and self.pose is not None:
            pose_dev, ok_dev = _localize_step(
                self.ms, torch.as_tensor(self.pose).to(dev), self.last_odom, feats, odo,
                self.min_tracked_matches, self.cfg)
            # ONE host read: the pose and the decision together
            self.host_reads += 1
            vals = _step_vals(pose_dev, ok_dev).cpu().numpy()
            if vals[3] > 0:
                self._accept(vals[:3], odo, tracked=True)
                return self.pose.copy()
            self.lost = True
        return self._lost_frame(feats, odo)

    def _lost_frame(self, feats: OrbFeatures, odo) -> np.ndarray | None:
        """The lost path (src/Localizer.cpp:88-155): BoW relocalization, or
        a hole in the trajectory."""
        pose = self._relocalize(feats)
        if pose is not None:
            self._accept(pose, odo, tracked=False)
            return self.pose.copy()
        self.trajectory.append((self.frame_id, None, False))
        self.frame_id += 1
        self.last_odom = odo
        return None

    # -- pipelined feed --

    def process_async(self, img, odo) -> np.ndarray | None:
        """Pipelined feed: run this frame's tracked step now, resolve the
        frame submitted ``pipeline_depth`` calls earlier and return its
        pose (None while the pipeline fills, or where that frame stayed
        lost; ``flush_async`` drains the rest). The results are
        ``process``'s; a resolve that loses tracking relocalizes on the
        host and re-runs the frames in flight from the new pose."""
        return self.process_features_async(self.extract(img), odo)

    def process_features_async(self, feats: OrbFeatures, odo) -> np.ndarray | None:
        odo = torch.as_tensor(odo, dtype=torch.float32).to(self.device)
        if (self.lost or self.pose is None) and not self._pipe:
            # cold start or lost with nothing in flight: relocalization is
            # the host's, frame by frame
            return self.process_features(feats, odo)
        self._pipe_submit(feats, odo)
        out = None
        while len(self._pipe) > max(0, int(self.pipeline_depth)):
            out = self._pipe_resolve_one()
        return out

    def flush_async(self) -> list:
        """Resolve every in-flight frame; their poses (None where lost)."""
        out = []
        while self._pipe:
            out.append(self._pipe_resolve_one())
        return out

    def _drain_pipe(self):
        while self._pipe:
            self._pipe_resolve_one()

    def _pipe_step(self, base_pose, base_odom, feats, odo):
        pose_dev, ok_dev = _localize_step(self.ms, base_pose, base_odom, feats, odo,
                                          self.min_tracked_matches, self.cfg)
        return pose_dev, host_prefetch(_step_vals(pose_dev, ok_dev))

    def _pipe_submit(self, feats: OrbFeatures, odo):
        # the base: the newest in-flight step, else the tracked state; a
        # frame queued behind an unspeculated one waits for the host path
        if self._pipe:
            prev = self._pipe[-1]
            base = (prev[2], prev[1]) if prev[2] is not None else None
        elif not self.lost and self.pose is not None:
            base = (torch.as_tensor(self.pose).to(self.device), self.last_odom)
        else:
            base = None
        if base is None:
            self._pipe.append([feats, odo, None, None])
            return
        self._pipe.append([feats, odo, *self._pipe_step(base[0], base[1], feats, odo)])

    def _pipe_resolve_one(self):
        feats, odo, pose_dev, copy = self._pipe.popleft()
        if pose_dev is None:
            return self._resolve_host(feats, odo)
        self.host_reads += 1
        vals = copy.get()[0]
        if vals[3] > 0:
            # an accepted frame's pose is its speculative step's: the frames
            # in flight stay valid
            self._accept(vals[:3], odo, tracked=True)
            return self.pose.copy()
        self.lost = True
        out = self._lost_frame(feats, odo)
        if self._pipe:
            if not self.lost:
                self._pipe_replay()        # again from the relocalized pose
            else:
                for e in self._pipe:       # still lost: the host path, in order
                    e[2] = e[3] = None
        return out

    def _resolve_host(self, feats: OrbFeatures, odo):
        self._in_resolve = True
        try:
            return self.process_features(feats, odo)
        finally:
            self._in_resolve = False

    def _pipe_replay(self):
        base_pose = torch.as_tensor(self.pose).to(self.device)
        base_odom = self.last_odom
        for e in self._pipe:
            e[2], e[3] = self._pipe_step(base_pose, base_odom, e[0], e[1])
            base_pose, base_odom = e[2], e[1]

    # -- chunked feed --

    def extract_batch(self, imgs) -> OrbFeatures:
        """k frames in one batched extraction (``OrbExtractor.forward_batch``):
        OrbFeatures with a leading k axis."""
        feats = self._extract.forward_batch(stack_images(imgs, self.device))
        if self._undistort:
            feats = feats._replace(xy=undistort_points(self._cam, feats.xy))
        return feats

    def process_chunk(self, imgs, odos) -> list:
        """Localize k (image, odometry) pairs with ONE host read per tracked
        run: ``_localize_chunk`` speculates over the chunk, tracked frames
        take its poses, and the first lost frame goes to the per-frame
        relocalization before the chunk resumes. Returns k poses (None
        where lost), ``process``'s."""
        k = len(imgs)
        check_chunk(imgs, odos)
        self._drain_pipe()
        out: list = []
        idx = 0
        # cold start or lost: relocalization is per frame
        while (self.lost or self.pose is None) and idx < k:
            out.append(self.process(imgs[idx], odos[idx]))
            idx += 1
        if idx == k:
            return out
        kk = k - idx
        feats_stack = self.extract_batch(imgs[idx:])
        odo_stack = torch.stack([torch.as_tensor(o, dtype=torch.float32).to(self.device)
                                 for o in odos[idx:]])
        i = 0
        while i < kk:
            if self.lost:
                out.append(self.process_features(chunk_frame(feats_stack, i), odo_stack[i]))
                i += 1
                continue
            poses, tracked = _localize_chunk(
                self.ms, torch.as_tensor(self.pose).to(self.device), self.last_odom,
                feats_stack, odo_stack, i, kk, self.min_tracked_matches, self.cfg)
            # ONE read for the whole tracked run
            self.host_reads += 1
            vals = torch.cat([tracked.to(torch.float32), poses.reshape(-1)]).cpu().numpy()
            n = odo_stack.shape[0]
            tr_h, poses_h = vals[:n] > 0, vals[n:].reshape(n, 3)
            j = i
            while j < kk and tr_h[j]:
                self._accept(poses_h[j], odo_stack[j], tracked=True)
                out.append(self.pose.copy())
                j += 1
            if j == kk:
                break
            # frame j failed the gates: the steps after it ran frozen
            self.frozen_steps += kk - 1 - j
            self.lost = True
            i = j
        return out

    # -- internals --

    def _accept(self, pose, odo, tracked: bool):
        self.pose = np.array(pose, np.float32)
        self.last_odom = odo
        self.lost = False
        self.trajectory.append((self.frame_id, self.pose.copy(), tracked))
        self.frame_id += 1

    def _relocalize(self, feats: OrbFeatures):
        """The top-3 BoW candidates in order, until one verifies: the best
        hit can be a sparse early keyframe when a runner-up verifies."""
        if self.bank is None:
            return None
        v, _ = vocab_mod.bow_transform(self.vocab, feats.desc_pm1, feats.valid)
        scores = vocab_mod.bow_score(self.bank, v)
        scores = torch.where(self.ms.kf_valid, scores, torch.full_like(scores, float("-inf")))
        top_scores, top_cands = top_k(scores, min(3, scores.shape[0]))
        # one read for all candidates
        top = torch.stack([top_scores.double(), top_cands.double()]).cpu().numpy()
        for score, cand in top.T:
            if score < self.reloc_min_score:
                break
            pose = self._relocalize_at(int(cand), feats)
            if pose is not None:
                return pose
        return None

    def _relocalize_at(self, cand: int, feats: OrbFeatures):
        cfg, ms = self.cfg, self.ms
        if self.reloc_gumbel is not None:
            noise = dict(gumbel=torch.as_tensor(self.reloc_gumbel()).to(self.device))
        else:
            noise = dict(generator=self.generator)
        n_in, mp_idx, uv, pair = _relocalize_verify(
            ms, cand, feats, n_trials=cfg.cap.ransac_trials, **noise)
        if int(n_in) < self.reloc_min_inliers:
            return None
        # the pose from the direct 2D-3D matches, seeded at the candidate's
        # pose, then projection-refinement rounds (src/Localizer.cpp:121-140)
        pose, _chi, n_ok = solve_pose_only(
            ms.kf_pose[cand], ms.mp_pos[mp_idx.long()], uv, pair, self._cam, self._Tcb,
            iters=30)
        if int(n_ok) < self.min_tracked_matches:
            return None
        for _ in range(2):
            feat_match, n = _project_and_match(ms, feats, pose, cfg)
            if int(n) < self.min_tracked_matches:
                return None
            m = feat_match.clamp(min=0).long()
            pose, _chi, n_ok = solve_pose_only(
                pose, ms.mp_pos[m], feats.xy, feat_match >= 0, self._cam, self._Tcb,
                iters=30)
        if int(n_ok) < self.min_tracked_matches:
            return None
        return pose.cpu().numpy()

    def save_trajectory(self, path: str):
        """Per-frame CSV: frame_id, x, y, theta, tracked
        (Localizer::WriteTrajFile, src/Localizer.cpp:178-193)."""
        with open(path, "w") as f:
            for fid, p, tracked in self.trajectory:
                if p is None:
                    f.write(f"{fid},nan,nan,nan,0\n")
                else:
                    f.write(f"{fid},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},{int(tracked)}\n")


def _step_vals(pose, ok):
    """A tracked step's one read: the pose and the decision as (4,) f32."""
    return torch.cat([pose, ok.to(torch.float32)[None]])
