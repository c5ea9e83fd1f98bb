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

The pipelined and chunked feeds (``process_async``,
``process_features_async``, ``flush_async``, ``process_chunk``) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import warnings

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
    seen = torch.zeros(K + 1, dtype=torch.bool, device=obs.device)
    seen[torch.where(ok, obs, torch.full_like(obs, K)).long()] = True
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
        dev = self.device
        odo = torch.as_tensor(odo, dtype=torch.float32).to(dev)

        if not self.lost and self.pose is not None:
            pose_dev, ok_dev = _localize_step(
                self.ms, torch.as_tensor(self.pose).to(dev), self.last_odom, feats, odo,
                self.min_tracked_matches, self.cfg)
            # ONE host read: the pose and the decision together
            vals = torch.cat([pose_dev, ok_dev.to(torch.float32)[None]]).cpu().numpy()
            if vals[3] > 0:
                self._accept(vals[:3], odo, tracked=True)
                return self.pose.copy()
            self.lost = True

        # lost → BoW relocalization (src/Localizer.cpp:88-155)
        pose = self._relocalize(feats)
        if pose is not None:
            self._accept(pose, odo, tracked=False)
            return self.pose.copy()
        self.trajectory.append((self.frame_id, None, False))
        self.frame_id += 1
        self.last_odom = odo
        return None

    # -- feeds not ported yet --

    def process_async(self, *args, **kwargs):
        raise _not_ported("Localizer.process_async")

    def process_features_async(self, *args, **kwargs):
        raise _not_ported("Localizer.process_features_async")

    def flush_async(self, *args, **kwargs):
        raise _not_ported("Localizer.flush_async")

    def process_chunk(self, *args, **kwargs):
        raise _not_ported("Localizer.process_chunk")

    # -- internals --

    def _accept(self, pose, odo, tracked: bool):
        self.pose = np.asarray(pose, np.float32)
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


def _not_ported(what: str):
    return NotImplementedError(
        f"se2lam_tpu_torch: {what} is not ported yet (the pipelined and chunked "
        "feeds, item 17 of ROADMAP.md §1)")
