"""System shell (port of se2lam_tpu.system.SlamSystem; reference OdoSLAM,
src/OdoSLAM.cpp:75-215): per frame, ORB extraction and the tracking step;
where tracking asks for a keyframe, keyframe insertion with data
association, pruning and local BA (``localmap``), then the loop-closing
stage (``loopclose.LoopCloser``): loop detection, verification, map-point
fusion and the global BAs, which land before tracking reseeds on the new
keyframe.

One host read per tracked frame brings back the keyframe decision, the
pose and the map's keyframe and point counts; a keyframe insertion adds
one for the new reference slot and pose, and the loop stage one for its
decisions. (The JAX package defers the insertion's read to the next
frame's, to hide a remote chip's round trip; the anchors and
``corrected_trajectory()`` come out the same.)

When the keyframe bank is full, forced pruning at a relaxed redundancy bar
and a slot compaction free room (``_relieve_capacity``); when the next
insertion could overflow the map-point bank, the weakest points are culled
and the point slots compacted (``_relieve_mp_capacity``). Host-side slot
references (anchors, keyframe frame ids, the loop closer's bank and
throttle) follow the compaction.

``save_map`` writes the map with its vocabulary in the JAX package's
format, and ``resume`` continues SLAM on a saved map: its first frame
relocalizes through a ``Localizer`` and becomes a keyframe chained from the
loaded map's tail.

Not ported yet, and raising ``NotImplementedError``: a device mesh, and the
pipelined and chunked feeds (``ROADMAP.md`` §1). Both ``async_mapping``
values run the one loop stage in the order of the synchronous mode.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import localmap, tracking
from .config import SystemConfig
from .device import resolve_device
from .frontend.orb import OrbConfig, OrbExtractor, OrbFeatures
from .io.mapstorage import load_map, save_map as _save_map
from .io.trajectory import save_trajectory
from .localizer import Localizer
from .loopclose import LoopCloser
from .mapstate import MapState, empty_map
from .ops import se2
from .ops.camera import CameraModel, undistort_points
from .vocab import train_vocab

__all__ = ["SlamSystem"]


def _np_se2_minus(pose, ref):
    """Host-side ``se2.minus``: ``pose`` expressed in ``ref``'s frame."""
    dx, dy = pose[0] - ref[0], pose[1] - ref[1]
    c, s = np.cos(ref[2]), np.sin(ref[2])
    dt = pose[2] - ref[2]
    return np.asarray(
        [c * dx + s * dy, -s * dx + c * dy, np.arctan2(np.sin(dt), np.cos(dt))],
        np.float32,
    )


def _np_se2_compose(a, rel):
    """Host-side ``se2.compose``: the inverse of _np_se2_minus."""
    c, s = np.cos(a[2]), np.sin(a[2])
    th = a[2] + rel[2]
    return np.asarray(
        [a[0] + c * rel[0] - s * rel[1], a[1] + s * rel[0] + c * rel[1],
         np.arctan2(np.sin(th), np.cos(th))],
        np.float32,
    )


def _not_in_slice(what: str, where: str):
    return NotImplementedError(
        f"se2lam_tpu_torch: {what} is not ported yet ({where} of ROADMAP.md §1)")


class SlamSystem:
    """Monocular + wheel-odometry SE(2) SLAM engine, synchronous feed::

        slam = SlamSystem(cfg)                           # the card
        for img, odo in dataset:
            slam.process(img, odo)
        slam.save_kf_trajectory(path)

    ``device=None`` means CUDA and raises without a card. Tracking's RANSAC
    samples come from ``generator`` (a ``torch.Generator`` on the device,
    seeded 0 when not given) or, frame by frame, from the ``gumbel``
    noise passed to ``process``; the loop closer has its own generator.
    ``enable_loops=False`` turns the whole global stage off;
    ``detect_loops=False`` keeps feature edges and the renewal GlobalBA
    but detects no loops (the faithful loop-ablated configuration).
    """

    def __init__(self, cfg: SystemConfig, enable_loops: bool = True, mesh=None,
                 async_mapping: bool = True, detect_loops: bool = True,
                 device=None, generator: torch.Generator | None = None):
        if mesh is not None:
            raise _not_in_slice("the distributed mode (mesh)", "slice 5, item 20")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.orb_cfg = OrbConfig(
            height=cfg.height, width=cfg.width, n_features=cfg.cap.n_features,
            scale_factor=cfg.scale_factor, n_levels=cfg.max_level,
        )
        # frame feature capacity must match the map's feature axis
        assert self.orb_cfg.n_slots == cfg.cap.n_features, (
            self.orb_cfg.n_slots, cfg.cap.n_features)
        self._extract = OrbExtractor(self.orb_cfg, device=self.device)
        self._cam = CameraModel.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist,
                                       device=self.device)
        self._undistort = any(abs(d) > 0 for d in cfg.dist)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator

        self.ms: MapState = empty_map(cfg.cap, self.device)
        self.ts = None
        self.frame_id = 0
        self.kf_frame_ids: list[int] = []
        self.trajectory: list[tuple[int, np.ndarray]] = []
        # (frame_id, ref_kf_slot, pose ⊖ ref_pose) per frame, for
        # re-anchoring the live trajectory after local BA moves the KFs
        self._frame_anchors: list[tuple[int, int, np.ndarray]] = []
        self._ref_kf_host = 0
        self._ref_pose_host = np.zeros(3, np.float32)
        self.timings: dict[str, float] = {}
        self.n_local_ba = 0
        self.log_ba = False
        self.ba_log: list[dict] = []
        self._resume_pending = False
        self._reloc_localizer: Localizer | None = None
        # capacity-pressure telemetry: successful keyframe-side reliefs;
        # anchors moved off a compacted keyframe; at_capacity when even
        # forced pruning freed nothing (mapping pauses, tracking coasts)
        self.capacity_compactions = 0
        self.anchors_reanchored = 0
        self.at_capacity = False
        # map-point-side pressure telemetry (_relieve_mp_capacity)
        self.mp_compactions = 0
        self.mp_culled_weak = 0
        self.mp_slots_reclaimed = 0
        self._loop_closer = (LoopCloser(cfg, detect_loops=detect_loops, device=self.device)
                             if enable_loops else None)

    @classmethod
    def resume(cls, cfg: SystemConfig, map_path: str, enable_loops: bool = True, mesh=None,
               device=None, generator: torch.Generator | None = None) -> "SlamSystem":
        """Continue SLAM on a saved map (the reference's USE_PREV_MAP mode,
        src/OdoSLAM.cpp:112-115 + MapStorage::loadMap). The first frames
        relocalize against the loaded map (BoW + RANSAC-verified 2D-3D
        matches, ``Localizer(reloc_min_inliers=30)``) and are reported at
        the origin until one succeeds; that frame becomes a keyframe in the
        loaded map's gauge. The map must have been saved with its
        vocabulary and at this ``cfg``'s capacities. ``generator`` gives
        the relocalization's RANSAC draws and then tracking's."""
        slam = cls(cfg, enable_loops=enable_loops, mesh=mesh, device=device,
                   generator=generator)
        ms, vocab, info = load_map(map_path, slam.device)
        if vocab is None:
            raise ValueError("resume requires a map saved with its vocabulary "
                             "(needed to relocalize the first frame)")
        caps = (cfg.cap.max_kfs, cfg.cap.max_mps, cfg.cap.n_features)
        if (ms.K, ms.M, ms.N) != caps:
            raise ValueError(f"config capacities {caps} do not match the saved "
                             f"map's {(ms.K, ms.M, ms.N)}")
        if info["n_kf"] >= cfg.cap.max_kfs:
            raise ValueError("saved map is at keyframe capacity; no slot for the "
                             "relocalization seed — raise cap.max_kfs")
        slam.ms = ms
        # kf_frame_ids stays slot-indexed: loaded keyframes have no frame id
        slam.kf_frame_ids = [-1] * int(info["n_kf"])
        if slam._loop_closer is not None:
            # the saved vocabulary, and the bank of the loaded keyframes
            slam._loop_closer.adopt_vocab(vocab, ms)
        slam._resume_pending = True
        slam._reloc_localizer = Localizer(cfg, ms, vocab, reloc_min_inliers=30,
                                          device=slam.device, generator=slam.generator)
        return slam

    def _try_resume_reloc(self, feats: OrbFeatures, odo) -> bool:
        """Relocalize a resumed session's frame; on success insert it as a
        keyframe at the relocalized pose and start tracking. The seed chains
        from the loaded map's tail (whose next-keyframe slot is free) with a
        near-uninformative 1e6·I covariance: no odometry spans the gap
        between the sessions."""
        pose = self._reloc_localizer.process_features(feats, odo)
        if pose is None:
            return False
        dev = self.device
        ref_idx = int(self.ms.n_kf) - 1
        pose_t = torch.from_numpy(pose).to(dev)
        n = self.orb_cfg.n_slots
        ts = tracking.init_track_state(
            feats, pose_t, odo, ref_idx, torch.zeros((n, 3), dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))
        self.ts = ts._replace(
            cur_pose=pose_t, pre_meas=se2.minus(pose_t, self.ms.kf_pose[ref_idx]),
            pre_cov=torch.eye(3, dtype=torch.float32, device=dev) * 1e6)
        self._insert_keyframe(feats, odo)
        self._resume_pending = False
        # tracking owns the map from here; the Localizer's copy and bank go
        self._reloc_localizer = None
        return True

    # -- feeds not in this slice --

    def process_async(self, *args, **kwargs):
        raise _not_in_slice("the pipelined feed (process_async)", "slice 5, item 17")

    def process_chunk(self, *args, **kwargs):
        raise _not_in_slice("the chunked feed (process_chunk)", "slice 5, item 17")

    def process_chunk_async(self, *args, **kwargs):
        raise _not_in_slice("the chunked feed (process_chunk_async)", "slice 5, item 17")

    # -- main synchronous step --

    def extract(self, img) -> OrbFeatures:
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.asarray(img))
        feats = self._extract(img.to(self.device))
        if self._undistort:
            feats = feats._replace(xy=undistort_points(self._cam, feats.xy))
        return feats

    def process(self, img, odo, gumbel=None) -> np.ndarray:
        """Feed one (image, odometry) pair; returns the body pose (3,).
        ``gumbel``: this frame's RANSAC noise (ransac_trials, N), instead
        of drawing from the generator."""
        return self.process_features(self.extract(img), odo, gumbel=gumbel)

    def process_features(self, feats: OrbFeatures, odo, gumbel=None) -> np.ndarray:
        cfg, dev = self.cfg, self.device
        odo = torch.as_tensor(odo, dtype=torch.float32).to(dev)
        zero = torch.zeros(3, dtype=torch.float32, device=dev)

        if self.ts is None and self._resume_pending:
            # resumed session: relocalize against the loaded map first
            pose = np.zeros(3, np.float32)
            if self._try_resume_reloc(feats, odo):
                pose = self._ref_pose_host.copy()
                # the seed frame is anchored on its own keyframe
                self._frame_anchors.append(
                    (self.frame_id, self._ref_kf_host, np.zeros(3, np.float32)))
            self.trajectory.append((self.frame_id, pose))
            self.frame_id += 1
            return pose

        if self.ts is None:
            # first frame → KF 0 at the origin if enough keypoints
            # (Track::mCreateFrame needs >100, src/Track.cpp:105-120)
            if int(feats.n) > min(100, cfg.cap.n_features // 4):
                self.ms = localmap.insert_first_kf(self.ms, feats, zero, odo)
                view_mp, obs_mask = localmap.kf_track_seed(self.ms, 0)
                self.ts = tracking.init_track_state(feats, zero, odo, 0, view_mp, obs_mask)
                self.kf_frame_ids.append(self.frame_id)
            pose = np.zeros(3, np.float32)
            self.trajectory.append((self.frame_id, pose))
            self.frame_id += 1
            return pose

        t0 = time.perf_counter()
        if gumbel is not None:
            gumbel = torch.as_tensor(gumbel, dtype=torch.float32).to(dev)
        self.ts, res = tracking.track_frame(
            self.ts, feats, odo, cfg,
            generator=None if gumbel is not None else self.generator, gumbel=gumbel)
        # ONE host read per frame for the control decisions and the pose
        # (f32 holds the counts exactly)
        vals = torch.cat([
            res.need_kf.to(torch.float32)[None], res.pose,
            self.ms.n_kf.to(torch.float32)[None], self.ms.n_mp.to(torch.float32)[None],
        ]).cpu().numpy()
        need_kf, pose = bool(vals[0]), vals[1:4].copy()
        n_kf, n_mp = int(vals[4]), int(vals[5])
        self.timings["track"] = time.perf_counter() - t0
        return self._apply_frame_decisions(need_kf, pose, n_kf, n_mp, feats, odo)

    def _apply_frame_decisions(self, need_kf, pose, n_kf, n_mp,
                               feats: OrbFeatures, odo) -> np.ndarray:
        """Host-side per-frame control: anchor record, keyframe decision,
        trajectory append."""
        cfg = self.cfg
        self._frame_anchors.append(
            (self.frame_id, self._ref_kf_host, _np_se2_minus(pose, self._ref_pose_host)))
        if need_kf:
            if n_kf >= cfg.cap.max_kfs:
                # capacity pressure: force pruning at a stepwise-relaxed
                # redundancy bar, then compact slot holes (the reference
                # never frees memory; Map::pruneRedundantKF is the machinery
                # this extends, src/Map.cpp:146-283)
                self._relieve_capacity()
            else:
                self.at_capacity = False
            if n_mp + cfg.cap.n_features > cfg.cap.max_mps:
                # the insert may mint up to N points: reclaim holes, cull
                # the weakest first
                self._relieve_mp_capacity()
            if not self.at_capacity:
                self._insert_keyframe(feats, odo)
        self.trajectory.append((self.frame_id, pose))
        self.frame_id += 1
        return pose

    def _insert_keyframe(self, feats: OrbFeatures, odo):
        cfg, ts = self.cfg, self.ts
        # protect: the outgoing tracking reference — recent frames'
        # anchors point at it
        t0 = time.perf_counter()
        self.ms, k, view_mp, obs_mask, ba_info = localmap.insert_and_optimize(
            self.ms, feats, ts.cur_pose, odo, ts.ref_kf_idx, ts.match_idx,
            ts.local_mps, ts.local_mp_valid, ts.good_prl, ts.pre_meas, ts.pre_cov,
            self._ref_kf_host, cfg,
        )
        self.n_local_ba += 1
        self.timings["insert"] = time.perf_counter() - t0
        lc = self._loop_closer
        if lc is not None:
            # the closure (if any) lands before tracking reseeds on the new
            # keyframe, in both async_mapping modes
            t0 = time.perf_counter()
            self.ms = lc.on_new_kf_fused(self.ms, k)
            view_mp, obs_mask = localmap.kf_track_seed(self.ms, k)
            self.timings["loop"] = time.perf_counter() - t0

        # reset tracking against the (BA-refined) new reference KF
        # (Track::resetLocalTrack, src/Track.cpp:195-209)
        new_ref_pose = localmap._row(self.ms.kf_pose, k)
        self.ts = tracking.init_track_state(feats, new_ref_pose, odo, k, view_mp, obs_mask)
        self.kf_frame_ids.append(self.frame_id)
        vals = torch.cat([k.to(torch.float32)[None], new_ref_pose]).cpu().numpy()
        self._ref_kf_host = int(vals[0])
        self._ref_pose_host = vals[1:4].copy()
        # the fired frame became the keyframe: anchor it on its own slot
        if self._frame_anchors and self._frame_anchors[-1][0] == self.frame_id:
            self._frame_anchors[-1] = (self.frame_id, self._ref_kf_host,
                                       np.zeros(3, np.float32))
        if self.log_ba:
            # the printOptInfo analog (src/LocalMapper.cpp:374-440)
            rec = torch.stack([
                ba_info["chi2_init"].to(torch.float64), ba_info["chi2"].to(torch.float64),
                ba_info["lambda"].to(torch.float64), self.ms.n_kf.to(torch.float64),
                self.ms.mp_valid.sum().to(torch.float64), ba_info["iters"].to(torch.float64),
            ]).cpu().numpy()
            self.ba_log.append({
                "frame": self.frame_id, "kf": self._ref_kf_host,
                "chi2_init": float(rec[0]), "chi2": float(rec[1]), "lambda": float(rec[2]),
                "n_kf": int(rec[3]), "n_mp": int(rec[4]), "iters": int(rec[5]),
            })

    # -- capacity relief --

    def _relieve_capacity(self):
        """Forced prune + compaction when the keyframe bank is full: relax
        the redundancy bar 0.8 → 0.7 → 0.6 → 0.0 (marginalize-oldest:
        any interior chain keyframe, its odometry edges spliced) until the
        live count is 1/8 of the bank below the cap, then renumber the map
        and every host-side slot reference. ``at_capacity`` when nothing
        was freed: mapping pauses, tracking coasts on odometry."""
        cfg = self.cfg
        target = cfg.cap.max_kfs - max(1, cfg.cap.max_kfs // 8)
        # the live count: holes left by per-insert pruning may suffice
        n_valid = int(self.ms.kf_valid.sum())
        for ratio in (0.8, 0.7, 0.6, 0.0):
            while n_valid > target:
                for _ in range(3):
                    self.ms, _ = localmap.prune_redundant_kf(
                        self.ms, self._ref_kf_host, protect=self._ref_kf_host, cfg=cfg,
                        min_ratio=ratio)
                new_valid = int(self.ms.kf_valid.sum())
                if new_valid == n_valid:
                    break                 # no progress at this bar
                n_valid = new_valid
            if n_valid <= target:
                break
        self._compact_and_remap()
        freed = int(self.ms.n_kf) < cfg.cap.max_kfs
        self.capacity_compactions += int(freed)
        self.at_capacity = not freed

    def _compact_and_remap(self):
        """Renumber keyframe and point slots (``localmap.compact_map``) and
        remap every host-side slot reference."""
        old_kf_pose = self.ms.kf_pose.cpu().numpy()
        n_mp_before = int(self.ms.n_mp)
        self.ms, kf_perm, _mp_perm = localmap.compact_map(self.ms)
        # lifetime mints = n_mp + mp_slots_reclaimed
        self.mp_slots_reclaimed += n_mp_before - int(self.ms.n_mp)
        self._remap_slots(kf_perm.cpu().numpy(), old_kf_pose)

    def _relieve_mp_capacity(self):
        """The map-point watermark response: reclaim the holes culling,
        merging and pruning left and, only when the map is genuinely dense,
        cull the weakest points down to a low-water mark (at least one
        insertion's worth plus 1/8 of the bank, floored at M/4). Point slots
        have no host-side references, so nothing is remapped."""
        cfg = self.cfg
        M = cfg.cap.max_mps
        target = max(M // 4, M - max(cfg.cap.n_features, M // 8))
        n_mp_before = self.ms.n_mp
        self.ms, n_culled = localmap.relieve_mp_pressure(self.ms, target, self._ref_kf_host)
        culled, reclaimed = (int(x) for x in torch.stack(
            [n_culled, n_mp_before - self.ms.n_mp]).cpu())
        self.mp_culled_weak += culled
        self.mp_slots_reclaimed += reclaimed
        self.mp_compactions += 1

    def _remap_slots(self, kf_perm: np.ndarray, old_kf_pose: np.ndarray):
        """Apply a compaction permutation to every host-side slot reference:
        the tracking reference, the slot-indexed frame ids, the anchors
        (those whose keyframe died are re-anchored rigidly on the nearest
        surviving keyframe, so later corrections still move them), the
        BA log, and the loop closer's bank and throttle."""
        new_ref = int(kf_perm[self._ref_kf_host])
        assert new_ref >= 0, "protected tracking reference was compacted away"
        self._ref_kf_host = new_ref
        if self.ts is not None:
            self.ts = self.ts._replace(
                ref_kf_idx=torch.tensor(new_ref, dtype=torch.int32, device=self.device))
        new_ids = [-1] * int(self.ms.n_kf)
        for old_slot, fid in enumerate(self.kf_frame_ids):
            if kf_perm[old_slot] >= 0:
                new_ids[int(kf_perm[old_slot])] = fid
        self.kf_frame_ids = new_ids
        alive_old = np.where(kf_perm >= 0)[0]
        anchors = []
        for fid, ref, rel in self._frame_anchors:
            if kf_perm[ref] >= 0:
                anchors.append((fid, int(kf_perm[ref]), rel))
            else:
                s_old = int(alive_old[np.argmin(np.abs(alive_old - ref))])
                abs_pose = _np_se2_compose(old_kf_pose[ref], rel)
                anchors.append((fid, int(kf_perm[s_old]),
                                _np_se2_minus(abs_pose, old_kf_pose[s_old])))
                self.anchors_reanchored += 1
        self._frame_anchors = anchors
        for rec in self.ba_log:
            old = rec.get("kf", -1)
            rec["kf"] = int(kf_perm[old]) if old >= 0 and kf_perm[old] >= 0 else -1
        lc = self._loop_closer
        if lc is not None and lc.vocab is not None:
            lc.rebuild_bank(self.ms)      # same vocabulary: the retrain schedule stays
        if lc is not None and lc.last_loop is not None:
            # the throttle compares slot ids (insertion-ordered): a dead
            # slot takes its rank among the survivors
            def new_slot(old: int) -> int:
                if kf_perm[old] >= 0:
                    return int(kf_perm[old])
                return int(np.sum(kf_perm[:old] >= 0))

            alive = all(kf_perm[o] >= 0 for o in lc.last_loop)
            lc.last_loop = (new_slot(lc.last_loop[0]), new_slot(lc.last_loop[1]))
            if not alive:
                lc.last_loop_midx = None

    # -- outputs (OdoSLAM::saveMap trajectory dump, src/OdoSLAM.cpp:199-214) --

    def current_pose(self) -> np.ndarray:
        if self.trajectory:
            return self.trajectory[-1][1]
        return np.zeros(3, np.float32)

    def kf_trajectory(self) -> np.ndarray:
        """(nKF, 5) rows of [idKF, x, y, z, yaw] in the reference format."""
        n = int(self.ms.n_kf)
        poses = self.ms.kf_pose[:n].cpu().numpy()
        valid = self.ms.kf_valid[:n].cpu().numpy()
        rows = [[i, p[0], p[1], 0.0, p[2]] for i, p in enumerate(poses) if valid[i]]
        return np.asarray(rows, np.float64).reshape(-1, 5)

    def save_kf_trajectory(self, path: str):
        save_trajectory(path, self.kf_trajectory())

    def save_map(self, path: str, with_vocab: bool = True):
        """The shutdown save (SAVE_NEW_MAP and the keyframe-trajectory dump,
        src/OdoSLAM.cpp:192-215): the map in the JAX package's format, with
        the loop closer's vocabulary, or else a 512-word one trained over the
        keyframes' descriptors (one document per keyframe, at least two
        keyframes; the loop closer adopts it), when ``with_vocab``; and
        ``se2lam_kf_trajectory.txt`` beside it. Returns the saved
        vocabulary, or None."""
        ms, lc = self.ms, self._loop_closer
        vocab = lc.vocab if lc is not None else None
        if vocab is None and with_vocab and self.n_keyframes() >= 2:
            K, N = ms.K, ms.N
            valid = (ms.kf_feat_valid & ms.kf_valid[:, None]).reshape(-1)
            doc_ids = torch.arange(K, dtype=torch.int32, device=self.device).repeat_interleave(N)
            vocab = train_vocab(ms.kf_desc.reshape(-1, 256), valid, n_words=512, iters=5,
                                doc_ids=doc_ids, n_docs_cap=K)
            if lc is not None:
                lc.adopt_vocab(vocab, ms)
        vocab = vocab if with_vocab else None
        _save_map(path, ms, vocab)
        self.save_kf_trajectory(os.path.join(path, "se2lam_kf_trajectory.txt"))
        return vocab

    def corrected_trajectory(self) -> np.ndarray:
        """(n, 4) [frame_id, x, y, theta]: every frame's pose re-anchored on
        its reference keyframe's CURRENT estimate, so past frames gain from
        local BA after the fact."""
        kf_pose = self.ms.kf_pose.cpu().numpy()
        anchors = {fid: (ref, rel) for fid, ref, rel in self._frame_anchors}
        out = []
        for fid, live in self.trajectory:
            if fid in anchors:
                ref, rel = anchors[fid]
                p = _np_se2_compose(kf_pose[ref], rel)
            else:
                p = live                  # first frame(s): origin gauge
            out.append([fid, p[0], p[1], p[2]])
        return np.asarray(out, np.float64)

    def save_frame_trajectory(self, path: str):
        """Per-frame CSV: frame_id, x, y, theta."""
        with open(path, "w") as f:
            for fid, p in self.trajectory:
                f.write(f"{fid},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f}\n")

    def n_keyframes(self) -> int:
        return int(self.ms.n_kf)

    def n_map_points(self) -> int:
        return int(self.ms.mp_valid.sum())
