"""System shell (port of se2lam_tpu.system.SlamSystem; reference OdoSLAM,
src/OdoSLAM.cpp:75-215): per frame, ORB extraction and the tracking step;
where tracking asks for a keyframe, keyframe insertion with data
association, pruning and local BA (``localmap``), then the loop-closing
stage (``loopclose.LoopCloser``): loop detection, verification, map-point
fusion and the global BAs, which land before tracking reseeds on the new
keyframe.

One host read per tracked frame brings back the keyframe decision, the
pose and the map's keyframe and point counts; a keyframe insertion adds
one for the new reference slot and pose, and the loop stage two: which of
its candidate slots are filled (only those are verified), then its
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

Three more feeds give the same results as ``process`` (same keyframes and
poses, frame for frame):

- ``process_chunk`` takes k frames: one batched extraction
  (``extract_batch``: ⌈5k/8⌉ FAST+NMS launches at 5 levels), then
  ``tracking.track_chunk`` over the frames and ONE host read of the k
  decisions; where a keyframe fires at frame j the state there is rebuilt
  (``state_at_step``), the keyframe is inserted (with capacity relief and
  the loop stage, as ``process`` does) and the frames after j are tracked
  again from it, with the same RANSAC noise;
- ``process_async`` tracks each frame at once against the newest in-flight
  state and reads its decisions ``pipeline_depth`` frames later, through a
  device-to-host copy started at dispatch (``utils.prefetch``); a resolve
  that changes the tracking state replays the frames in flight;
- ``process_chunk_async`` does the same with whole chunks, one in flight.

Every tracked frame's RANSAC noise is drawn once, in frame order, by
``_draw_noise`` (``tracking.draw_track_noise`` from ``generator``, or the
``track_noise`` callable), whichever feed runs it. The JAX package's
deferred mirror of the reference keyframe serves its asynchronous mapping
over a remote chip; the port reads the mirror at the insertion. Without a
mesh the port runs the fused loop stage inside the insertion, in the
synchronous order, for both ``async_mapping`` values.

On a device mesh (``mesh=``, ``parallel.make_mesh``) the global stage runs
distributed (the loop closer's split BoW bank, the edge-sharded pose graph,
the map-block partitioned joint GBA with K3 on each block) and staged, as
the JAX package's mesh path: with ``async_mapping`` an insertion only
dispatches the stage's detection (``LoopCloser.start_async``) and starts
the copy of its values; each later control read advances the stage by one
step (``_advance_loop``), and a closure that lands re-bases the live
tracking gauge on the corrected reference keyframe (``_rebase_gauge``).
The next insertion, a relief, ``save_map`` and the trajectory outputs
finish a pending stage first. Without ``async_mapping`` the stage runs to
completion inside the insertion. Tracking and the local window stay on the
system's device, which must be the mesh's first.

``host_reads`` counts the control reads: one per decision read (a frame, a
chunk segment, a resolved in-flight frame) and one per keyframe insertion.

The stages open spans of ``utils.timing`` (recorded while a
``torch.profiler`` session records or inside ``timing.tracing()``; a flag
read otherwise), each inside the one above it:

- ``slam.frame`` (``process``/``process_features``; count ``keyframe``):
  ``slam.extract``, ``slam.track`` (the noise draw, ``track_frame`` and the
  decision read), ``slam.relief`` (either capacity relief), ``slam.insert``
  (``localmap.insert_and_optimize``, holding ``map.local_ba``),
  ``slam.loop`` (the loop stage) and ``slam.reseed`` (tracking reset on
  the new keyframe and its read);
- inside ``slam.loop`` (``loopclose``): ``loop.vocab`` (a vocabulary
  training), ``loop.detect`` (through the stage's decision read, holding
  ``loop.verify``, which counts ``live``, the slots it verified; counts
  ``verified``, the real candidates among the 5 slots, ``fired``,
  ``renewal``, ``feat_edges``) and,
  where a closure or a renewal runs, ``loop.correct`` with ``loop.merge``,
  ``loop.pose_graph`` and ``loop.joint_ba``;
- the ``Localizer``'s (``localizer.py``): ``loc.build``, ``loc.frame``
  (``Localizer.process``; count ``tracked``) with ``loc.extract``,
  ``loc.step`` (count ``ok``; ``loc.match``, ``loc.solve``) and
  ``loc.reloc`` (counts ``candidates``, ``ok``; ``loc.verify``,
  ``loc.refine``).

The stages' spans sit in the shared functions, so the chunked and
pipelined feeds record them too, without a frame around them; a feed
resolves the frames of another feed still in flight before it opens its
own frame. ``timing.RECORDER.report()`` sums each span's counts.
"""
from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from . import localmap, tracking
from .config import SystemConfig
from .device import resolve_device, same_device
from .frontend.orb import OrbConfig, OrbExtractor, OrbFeatures
from .io.mapstorage import load_map, save_map as _save_map
from .io.trajectory import save_trajectory
from .localizer import Localizer
from .loopclose import LoopCloser
from .mapstate import MapState, empty_map
from .ops import se2
from .ops.camera import CameraModel, undistort_points
from .utils.chunking import check_chunk, stack_images
from .utils.prefetch import HostCopy, host_prefetch
from .utils.timing import span
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


class SlamSystem:
    """Monocular + wheel-odometry SE(2) SLAM engine, synchronous feed::

        slam = SlamSystem(cfg)                           # the card
        for img, odo in dataset:
            slam.process(img, odo)
        slam.save_kf_trajectory(path)

    ``device=None`` means CUDA and raises without a card. Tracking's RANSAC
    samples come from ``generator`` (a ``torch.Generator`` on the device,
    seeded 0 when not given), or from ``track_noise`` (None, or a callable
    returning the next tracked frame's (ransac_trials, N) noise), or for
    one frame from the ``gumbel`` passed to ``process``; the loop closer
    has its own generator.
    ``enable_loops=False`` turns the whole global stage off;
    ``detect_loops=False`` keeps feature edges and the renewal GlobalBA
    but detects no loops (the faithful loop-ablated configuration).
    ``mesh``: a ``parallel.mesh.Mesh`` whose first block is ``device``;
    the global stage runs distributed over it (module docstring).
    """

    def __init__(self, cfg: SystemConfig, enable_loops: bool = True, mesh=None,
                 async_mapping: bool = True, detect_loops: bool = True,
                 device=None, generator: torch.Generator | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if mesh is not None and not same_device(mesh.devices[0], self.device):
            raise ValueError(f"the mesh's first block {mesh.devices[0]} is not the "
                             f"system's device {self.device}")
        self.mesh = mesh
        self.async_mapping = async_mapping
        # the staged loop stage of the mesh path: the pending record of
        # LoopCloser.start_async/advance and the copy of its values
        self._loop_pending = None
        self._loop_copy = None
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
        self._loop_closer = (LoopCloser(cfg, detect_loops=detect_loops, device=self.device,
                                        mesh=mesh) if enable_loops else None)
        self.track_noise = None
        self.host_reads = 0
        # pipelined per-frame feed: in-flight [feats, odo, noise, ts_new,
        # decision copy]; depth 4 as the JAX package's default
        self._pipe = deque()
        self.pipeline_depth = 4
        # chunk pipeline: at most one chunk in flight beyond the resolving one
        self._chunk_pipe = deque()
        self._prefetched = None
        # in-run observability, off until enable_viz: the image of the frame
        # being processed and of the current reference keyframe
        self._viz_dir: str | None = None
        self._viz_every = 5
        self._last_img = None
        self._ref_img = None
        # the split feed (receive_odo / receive_img): the newest reading of
        # each, until both are there; and the session's end (request_finish)
        self._pending_odo = None
        self._pending_img = None
        self._finished = False

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

    def enable_viz(self, out_dir: str, every_n_kf: int = 5, log_ba: bool = True):
        """Turn on the in-run observability: every ``every_n_kf`` keyframes,
        write the composed frame-debug image (the FramePublish canvas,
        src/FramePublish.cpp:152-203) and a map plot (the MapPublish role,
        src/MapPublish.cpp:529-581, by keyframe instead of by time) into
        ``out_dir``; with ``log_ba``, record each local BA's chi2 and counts
        in ``ba_log`` (the printOptInfo analog, src/LocalMapper.cpp:374-440).
        The images need matplotlib and PIL."""
        os.makedirs(out_dir, exist_ok=True)
        self._viz_dir = out_dir
        self._viz_every = max(1, every_n_kf)
        self.log_ba = log_ba

    # -- the split feed (OdoSLAM::receiveOdoData / receiveImgData) --

    def receive_odo(self, x, y, theta):
        """Hold an odometry reading (a later one replaces it); ``process``
        runs once an image is there too."""
        self._pending_odo = np.asarray([x, y, theta], np.float32)
        self._maybe_step()

    def receive_img(self, img):
        """Hold an image (a later one replaces it); ``process`` runs once an
        odometry reading is there too."""
        self._pending_img = img
        self._maybe_step()

    def _maybe_step(self):
        if self._pending_odo is not None and self._pending_img is not None:
            img, odo = self._pending_img, self._pending_odo
            self._pending_img = self._pending_odo = None
            self.process(img, odo)

    # -- main synchronous step --

    def extract(self, img) -> OrbFeatures:
        with span("slam.extract"):
            if not torch.is_tensor(img):
                img = torch.from_numpy(np.asarray(img))
            feats = self._extract(img.to(self.device))
            if self._undistort:
                feats = feats._replace(xy=undistort_points(self._cam, feats.xy))
            return feats

    def _draw_noise(self):
        """The next tracked frame's RANSAC noise: the one draw every feed
        makes per tracked frame, in frame order."""
        if self.track_noise is not None:
            return torch.as_tensor(self.track_noise(), dtype=torch.float32).to(self.device)
        return tracking.draw_track_noise(self.generator, self.cfg)

    def _decisions(self, need_kf, pose):
        """The values a frame's control read brings back, as one f32 vector:
        need_kf flags, poses, and the map's keyframe and point counts (f32
        holds the counts exactly)."""
        return torch.cat([
            need_kf.to(torch.float32).reshape(-1), pose.reshape(-1),
            self.ms.n_kf.to(torch.float32)[None], self.ms.n_mp.to(torch.float32)[None],
        ])

    def _read(self, vals) -> np.ndarray:
        """A control read: of a tensor now, or of a ``HostCopy`` started
        earlier."""
        self.host_reads += 1
        return vals.get()[0] if isinstance(vals, HostCopy) else vals.cpu().numpy()

    def process(self, img, odo, gumbel=None) -> np.ndarray:
        """Feed one (image, odometry) pair; returns the body pose (3,).
        ``gumbel``: this frame's RANSAC noise (ransac_trials, N), instead
        of drawing from the generator."""
        if self._viz_dir is not None:
            self._last_img = img
        self._drain_pipe()   # a mixed-mode caller: frames stay in order
        with span("slam.frame") as s:
            return self._frame(s, self.extract(img), odo, gumbel)

    def process_features(self, feats: OrbFeatures, odo, gumbel=None) -> np.ndarray:
        self._drain_pipe()
        with span("slam.frame") as s:
            return self._frame(s, feats, odo, gumbel)

    def _frame(self, s, feats: OrbFeatures, odo, gumbel) -> np.ndarray:
        """One frame inside its ``slam.frame`` span ``s``: ``_step``, and
        the span's ``keyframe`` count."""
        fid = self.frame_id
        pose = self._step(feats, odo, gumbel)
        s.count("keyframe", bool(self.kf_frame_ids) and self.kf_frame_ids[-1] == fid)
        return pose

    def _step(self, feats: OrbFeatures, odo, gumbel) -> np.ndarray:
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

        with span("slam.track"):
            gumbel = (self._draw_noise() if gumbel is None
                      else torch.as_tensor(gumbel, dtype=torch.float32).to(dev))
            self.ts, res = tracking.track_frame(self.ts, feats, odo, cfg, gumbel=gumbel)
            # ONE host read per frame for the control decisions and the pose
            vals = self._read(self._decisions(res.need_kf, res.pose))
        need_kf, pose = bool(vals[0]), vals[1:4].copy()
        n_kf, n_mp = int(vals[4]), int(vals[5])
        return self._apply_frame_decisions(need_kf, pose, n_kf, n_mp, feats, odo)

    def _apply_frame_decisions(self, need_kf, pose, n_kf, n_mp,
                               feats: OrbFeatures, odo) -> np.ndarray:
        """Host-side per-frame control: anchor record, keyframe decision,
        trajectory append."""
        self._frame_anchors.append(
            (self.frame_id, self._ref_kf_host, _np_se2_minus(pose, self._ref_pose_host)))
        # a pending loop stage advances one step on this read (after the
        # anchor, which pairs with the reference this frame was tracked on)
        self._advance_loop()
        if need_kf:
            self._keyframe_decision(n_kf, n_mp, feats, odo)
        self.trajectory.append((self.frame_id, pose))
        self.frame_id += 1
        return pose

    def _keyframe_decision(self, n_kf, n_mp, feats: OrbFeatures, odo):
        """A frame asked for a keyframe (``self.ts`` is the state after it):
        capacity relief where a bank is full, then the insertion."""
        cfg = self.cfg
        if n_kf >= cfg.cap.max_kfs:
            # capacity pressure: force pruning at a stepwise-relaxed
            # redundancy bar, then compact slot holes (the reference never
            # frees memory; Map::pruneRedundantKF is the machinery this
            # extends, src/Map.cpp:146-283)
            self._relieve_capacity()
        else:
            self.at_capacity = False
        if n_mp + cfg.cap.n_features > cfg.cap.max_mps:
            # the insert may mint up to N points: reclaim holes, cull the
            # weakest first
            self._relieve_mp_capacity()
        if not self.at_capacity:
            self._insert_keyframe(feats, odo)

    def _insert_keyframe(self, feats: OrbFeatures, odo):
        # the last keyframe's staged loop stage lands before this one
        self._finish_loop_pending()
        cfg, ts = self.cfg, self.ts
        # protect: the outgoing tracking reference — recent frames'
        # anchors point at it
        self.ms, k, view_mp, obs_mask, ba_info = localmap.insert_and_optimize(
            self.ms, feats, ts.cur_pose, odo, ts.ref_kf_idx, ts.match_idx,
            ts.local_mps, ts.local_mp_valid, ts.good_prl, ts.pre_meas, ts.pre_cov,
            self._ref_kf_host, cfg,
        )
        self.n_local_ba += 1
        lc = self._loop_closer
        reseed = False
        if lc is not None:
            with span("slam.loop"):
                if lc._dist and self.async_mapping:
                    # mesh path: dispatch the staged stage's detection; its
                    # values ride the next control reads (_advance_loop)
                    self._loop_pending = lc.start_async(self.ms, k)
                    self._loop_copy = host_prefetch(*self._loop_pending["want"])
                else:
                    # the closure (if any) lands before tracking reseeds on
                    # the new keyframe
                    self.ms = (lc.on_new_kf(self.ms, k) if lc._dist
                               else lc.on_new_kf_fused(self.ms, k))
                    reseed = True

        with span("slam.reseed"):
            if reseed:
                view_mp, obs_mask = localmap.kf_track_seed(self.ms, k)
            # reset tracking against the (BA-refined) new reference KF
            # (Track::resetLocalTrack, src/Track.cpp:195-209)
            new_ref_pose = localmap._row(self.ms.kf_pose, k)
            self.ts = tracking.init_track_state(feats, new_ref_pose, odo, k, view_mp, obs_mask)
            vals = self._read(torch.cat([k.to(torch.float32)[None], new_ref_pose]))
        self.kf_frame_ids.append(self.frame_id)
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
        if self._viz_dir is not None:
            if self._last_img is not None and len(self.kf_frame_ids) % self._viz_every == 0:
                self._emit_viz(feats, ts)
            self._ref_img = self._last_img

    def _emit_viz(self, feats: OrbFeatures, old_ts):
        """Write the composed frame-debug image and the map plot for the
        keyframe just inserted (host-side file IO; the reads are the
        dumps' own)."""
        from . import viz

        fid = self.frame_id
        loop_xy = loop_match = None
        lc = self._loop_closer
        if (lc is not None and lc.last_loop is not None and lc.last_loop_midx is not None
                and lc.last_loop[1] == self._ref_kf_host):
            loop_xy = self.ms.kf_xy[lc.last_loop[0]]
            loop_match = lc.last_loop_midx
        viz.compose_debug_image(
            os.path.join(self._viz_dir, f"frame_{fid:05d}.png"), self._last_img, feats,
            match_idx=old_ts.match_idx, ref_img=self._ref_img, ref_xy=old_ts.ref_feats.xy,
            loop_xy=loop_xy, loop_match=loop_match,
            label=f"f{fid} kf{len(self.kf_frame_ids)}")
        viz.plot_map(os.path.join(self._viz_dir, f"map_{fid:05d}.png"), self.ms,
                     title=f"map @ frame {fid}")

    # -- the staged loop stage of the mesh path --

    def _advance_loop(self, block: bool = False):
        """Advance the pending loop stage: one step on its values (copied
        since its dispatch), the next step's copy started; ``block`` runs
        it to completion. A closure re-bases the tracking gauge."""
        lc = self._loop_closer
        while self._loop_pending is not None:
            self.ms, self._loop_pending, closed = lc.advance(self.ms, self._loop_pending,
                                                             self._loop_copy.get())
            self._loop_copy = (host_prefetch(*self._loop_pending["want"])
                               if self._loop_pending is not None else None)
            if closed:
                self._rebase_gauge()
            if not block:
                return

    def _finish_loop_pending(self):
        self._advance_loop(block=True)

    def _rebase_gauge(self):
        """A global correction moved the reference keyframe: the live
        tracking state moves with it (the reference's Track reads the map
        pose GlobalBA wrote, src/GlobalMapper.cpp:496-531); the rest of the
        state is relative to the reference camera."""
        ts = self.ts
        if ts is None:
            return
        new_ref = self.ms.kf_pose[ts.ref_kf_idx.long()]
        self.ts = ts._replace(ref_pose=new_ref,
                              cur_pose=se2.compose(new_ref, se2.minus(ts.cur_pose, ts.ref_pose)))
        self._ref_pose_host = self._read(new_ref)[:3].copy()

    # -- pipelined per-frame feed --

    def process_async(self, img, odo) -> np.ndarray | None:
        """Pipelined feed: track this frame now, return the pose of the
        frame submitted ``pipeline_depth`` calls earlier (None while the
        pipeline fills; ``flush_async`` drains the rest). Each frame is
        tracked against the newest in-flight state, as if no keyframe
        fired, and its decisions' host copy starts at once; a resolve that
        changes the tracking state (keyframe insertion, loop closure,
        capacity relief) tracks the frames in flight again from the new
        state with their own noise, so the results are ``process``'s.
        Lowering ``pipeline_depth`` mid-stream resolves several frames in
        one call and returns the newest; all are in ``trajectory``."""
        if self._viz_dir is not None:
            self._last_img = img
        return self.process_features_async(self.extract(img), odo)

    def process_features_async(self, feats: OrbFeatures, odo) -> np.ndarray | None:
        while self._chunk_pipe:
            self._chunk_resolve_one()   # the feeds do not interleave
        if self.ts is None:
            # bootstrap or resume: nothing to track against yet
            assert not self._pipe
            return self.process_features(feats, odo)
        self._pipe_submit(feats, torch.as_tensor(odo, dtype=torch.float32).to(self.device))
        pose = None
        while len(self._pipe) > max(0, int(self.pipeline_depth)):
            pose = self._pipe_resolve_one()
        return pose

    def flush_async(self) -> np.ndarray:
        """Resolve every in-flight frame; their (n, 3) poses."""
        out = []
        while self._pipe:
            out.append(self._pipe_resolve_one())
        return np.asarray(out, np.float32).reshape(-1, 3)

    def _drain_pipe(self):
        while self._chunk_pipe:
            self._chunk_resolve_one()
        while self._pipe:
            self._pipe_resolve_one()

    def _pipe_track(self, base, feats, odo, noise):
        ts_new, res = tracking.track_frame(base, feats, odo, self.cfg, gumbel=noise)
        return ts_new, host_prefetch(self._decisions(res.need_kf, res.pose))

    def _pipe_submit(self, feats: OrbFeatures, odo):
        noise = self._draw_noise()
        base = self._pipe[-1][3] if self._pipe else self.ts
        ts_new, copy = self._pipe_track(base, feats, odo, noise)
        self._pipe.append([feats, odo, noise, ts_new, copy, self._last_img])

    def _pipe_resolve_one(self) -> np.ndarray:
        feats, odo, _noise, ts_new, copy, img = self._pipe.popleft()
        self.ts = ts_new
        if self._viz_dir is not None:
            self._last_img = img
        vals = self._read(copy)
        pose = self._apply_frame_decisions(bool(vals[0]), vals[1:4].copy(), int(vals[4]),
                                           int(vals[5]), feats, odo)
        if self._pipe and self.ts is not ts_new:
            self._pipe_replay()
        return pose

    def _pipe_replay(self):
        """Track the in-flight frames again from the corrected state, each
        with its own noise."""
        base = self.ts
        for e in self._pipe:
            e[3], e[4] = self._pipe_track(base, e[0], e[1], e[2])
            base = e[3]

    # -- chunked feed --

    def extract_batch(self, imgs) -> OrbFeatures:
        """Extract k frames in one batched pass (``OrbExtractor.forward_batch``;
        the stack crosses to the device in its own dtype, and is cast to
        f32 there): OrbFeatures with a leading k axis, frame by frame those
        of ``extract``. Takes the stack ``prefetch_chunk`` started for
        these very images, if any."""
        stack = self._take_prefetched(imgs)
        if stack is None:
            stack = stack_images(imgs, self.device)
        feats = self._extract.forward_batch(stack)
        if self._undistort:
            feats = feats._replace(xy=undistort_points(self._cam, feats.xy))
        return feats

    def prefetch_chunk(self, imgs):
        """Start the host-to-device copy of a future chunk's images now; the
        next ``extract_batch`` of the SAME image objects takes it, anything
        else drops it. The image objects are held, so their ids stay
        unique while the entry lives."""
        if not imgs:
            return
        if all(torch.is_tensor(im) for im in imgs):
            stack = stack_images(imgs, self.device)
        else:
            host = torch.from_numpy(np.stack([np.asarray(im) for im in imgs]))
            if self.device.type == "cuda":
                host = host.pin_memory()
            stack = host.to(self.device, non_blocking=True)
        self._prefetched = (tuple(id(im) for im in imgs), list(imgs), stack)

    def _take_prefetched(self, imgs):
        pref, self._prefetched = self._prefetched, None   # one-shot either way
        if pref is None or pref[0] != tuple(id(im) for im in imgs):
            return None
        return pref[2]

    def _chunk_inputs(self, imgs, odos, idx):
        """The features and odometry of the chunk's frames from ``idx`` on,
        on the device, and their noise, drawn now in frame order."""
        kk = len(imgs) - idx
        feats_stack = self.extract_batch(imgs[idx:])
        odo_stack = torch.stack([torch.as_tensor(o, dtype=torch.float32).to(self.device)
                                 for o in odos[idx:]])
        noise = tracking.split_chain(self._draw_noise, kk)
        return feats_stack, odo_stack, noise, kk

    def process_chunk(self, imgs, odos, next_imgs=None) -> np.ndarray:
        """Feed k (image, odometry) pairs with ONE decision read per segment
        (a segment ends where a keyframe fires) instead of one a frame;
        returns the (k, 3) poses, those ``process`` would give.
        ``next_imgs``: the next chunk's images, whose upload starts after
        this chunk's extraction is queued (``prefetch_chunk``)."""
        k = len(imgs)
        check_chunk(imgs, odos)
        self._drain_pipe()
        poses_out: list[np.ndarray] = []
        idx = 0
        # bootstrap and resume stay per-frame until tracking exists
        while self.ts is None and idx < k:
            poses_out.append(self.process(imgs[idx], odos[idx]))
            idx += 1
        if idx < k:
            feats_stack, odo_stack, noise, kk = self._chunk_inputs(imgs, odos, idx)
            if next_imgs is not None:
                self.prefetch_chunk(next_imgs)
            poses_out.extend(self._run_chunk_segments(feats_stack, odo_stack, noise, kk,
                                                      imgs[idx:]))
        return np.asarray(poses_out, np.float32).reshape(-1, 3)

    def _run_chunk_segments(self, feats_stack, odo_stack, noise, kk, imgs, first_seg=None):
        """The segment loop of both chunked feeds over the frames ``imgs``.
        ``first_seg``: segment 0's speculative pass dispatched earlier,
        (final state, ChunkSteps, decision copy); valid because a resolve
        that changed the state replayed it."""
        cfg = self.cfg
        poses_out: list[np.ndarray] = []
        i = 0
        while i < kk:
            if i == 0 and first_seg is not None:
                ts_f, steps, copy = first_seg
                vals = self._read(copy)
            else:
                ts_f, needs, poses, steps = tracking.track_chunk(
                    self.ts, feats_stack, odo_stack, noise, i, kk, cfg)
                vals = self._read(self._decisions(needs, poses))
            n = odo_stack.shape[0]
            needs_h, poses_h = vals[:n] > 0, vals[n:4 * n].reshape(n, 3)
            n_kf, n_mp = int(vals[4 * n]), int(vals[4 * n + 1])
            fire = next((j for j in range(i, kk) if needs_h[j]), None)
            upto = kk if fire is None else fire + 1
            for j in range(i, upto):
                pose = poses_h[j].copy()
                # the anchor against the reference before any insertion, as
                # the per-frame path orders it
                self._frame_anchors.append(
                    (self.frame_id, self._ref_kf_host, _np_se2_minus(pose, self._ref_pose_host)))
                if j == fire:
                    if self._viz_dir is not None:
                        self._last_img = imgs[fire]
                    feats_j = tracking.chunk_frame(feats_stack, fire)
                    self.ts = tracking.state_at_step(self.ts, feats_j, steps, fire)
                    self._advance_loop()
                    self._keyframe_decision(n_kf, n_mp, feats_j, odo_stack[fire])
                self.trajectory.append((self.frame_id, pose))
                self.frame_id += 1
                poses_out.append(pose)
            if fire is None:
                self.ts = ts_f
                self._advance_loop()
                break
            i = fire + 1
        return poses_out

    # -- chunk pipeline --

    def process_chunk_async(self, imgs, odos) -> np.ndarray | None:
        """Chunk pipeline: extract and track this chunk now, return the
        PREVIOUS chunk's (k, 3) poses (None on the first call;
        ``flush_chunk_async`` drains the last). Chunks met before tracking
        starts resolve at once and return their own poses. The results are
        ``process_chunk``'s."""
        k = len(imgs)
        check_chunk(imgs, odos)
        while self._pipe:
            self._pipe_resolve_one()    # the feeds do not interleave
        if self.ts is None:
            out = []
            while self._chunk_pipe:
                out.append(self._chunk_resolve_one())
            out.append(self.process_chunk(imgs, odos))
            return np.concatenate(out, 0)
        self._chunk_submit(imgs, odos)
        if len(self._chunk_pipe) > 1:
            return self._chunk_resolve_one()
        return None

    def flush_chunk_async(self) -> np.ndarray:
        """Resolve every in-flight chunk; their stacked poses."""
        out = [np.zeros((0, 3), np.float32)]
        while self._chunk_pipe:
            out.append(self._chunk_resolve_one())
        return np.concatenate(out, 0)

    def _chunk_track(self, e, base):
        ts_f, needs, poses, steps = tracking.track_chunk(
            base, e["feats"], e["odo"], e["noise"], 0, e["kk"], self.cfg)
        e.update(ts_f=ts_f, steps=steps, copy=host_prefetch(self._decisions(needs, poses)))

    def _chunk_submit(self, imgs, odos):
        feats_stack, odo_stack, noise, kk = self._chunk_inputs(imgs, odos, 0)
        e = dict(feats=feats_stack, odo=odo_stack, noise=noise, kk=kk, imgs=imgs)
        self._chunk_track(e, self._chunk_pipe[-1]["ts_f"] if self._chunk_pipe else self.ts)
        self._chunk_pipe.append(e)

    def _chunk_resolve_one(self) -> np.ndarray:
        e = self._chunk_pipe.popleft()
        poses_out = self._run_chunk_segments(e["feats"], e["odo"], e["noise"], e["kk"], e["imgs"],
                                             first_seg=(e["ts_f"], e["steps"], e["copy"]))
        if self._chunk_pipe and self.ts is not e["ts_f"]:
            # the state changed: track the chunks in flight again from it
            base = self.ts
            for nxt in self._chunk_pipe:
                self._chunk_track(nxt, base)
                base = nxt["ts_f"]
        return np.asarray(poses_out, np.float32).reshape(-1, 3)

    # -- capacity relief --

    def _relieve_capacity(self):
        """Forced prune + compaction when the keyframe bank is full: relax
        the redundancy bar 0.8 → 0.7 → 0.6 → 0.0 (marginalize-oldest:
        any interior chain keyframe, its odometry edges spliced) until the
        live count is 1/8 of the bank below the cap, then renumber the map
        and every host-side slot reference. ``at_capacity`` when nothing
        was freed: mapping pauses, tracking coasts on odometry."""
        # a pending loop stage holds slot ids: it lands first
        self._finish_loop_pending()
        with span("slam.relief"):
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
        self._finish_loop_pending()       # it holds point-table views
        cfg = self.cfg
        M = cfg.cap.max_mps
        target = max(M // 4, M - max(cfg.cap.n_features, M // 8))
        with span("slam.relief"):
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
        self._drain_pipe()
        if self.trajectory:
            return self.trajectory[-1][1]
        return np.zeros(3, np.float32)

    def kf_trajectory(self) -> np.ndarray:
        """(nKF, 5) rows of [idKF, x, y, z, yaw] in the reference format."""
        self._drain_pipe()
        self._finish_loop_pending()
        n = int(self.ms.n_kf)
        poses = self.ms.kf_pose[:n].cpu().numpy()
        valid = self.ms.kf_valid[:n].cpu().numpy()
        rows = [[i, p[0], p[1], 0.0, p[2]] for i, p in enumerate(poses) if valid[i]]
        return np.asarray(rows, np.float64).reshape(-1, 5)

    def save_kf_trajectory(self, path: str):
        save_trajectory(path, self.kf_trajectory())

    # -- the OdoSLAM-named surface (include/se2lam/OdoSLAM.h:27-59) --

    def receive_odo_data(self, x, y, theta, _timestamp=None):
        """OdoSLAM::receiveOdoData (the timestamp is not used)."""
        self.receive_odo(x, y, theta)

    def receive_img_data(self, img, _timestamp=None):
        """OdoSLAM::receiveImgData (the timestamp is not used)."""
        self.receive_img(img)

    def get_current_vehicle_pose(self) -> np.ndarray:
        """OdoSLAM::getCurrentVehiclePose: the body pose (x, y, theta)."""
        return self.current_pose()

    def request_finish(self):
        """OdoSLAM::requestFinish: resolves the frames in flight of a
        pipelined feed, lands a pending loop stage and marks the session
        done."""
        self._drain_pipe()
        self._finish_loop_pending()
        self._finished = True

    def wait_for_finish(self):
        """OdoSLAM::waitForFinish: as ``request_finish`` (nothing runs
        behind the caller's back, so there is nothing else to wait for)."""
        self.request_finish()

    def save_map(self, path: str, with_vocab: bool = True):
        """The shutdown save (SAVE_NEW_MAP and the keyframe-trajectory dump,
        src/OdoSLAM.cpp:192-215): the map in the JAX package's format, with
        the loop closer's vocabulary, or else a 512-word one trained over the
        keyframes' descriptors (one document per keyframe, at least two
        keyframes; the loop closer adopts it), when ``with_vocab``; and
        ``se2lam_kf_trajectory.txt`` beside it. Returns the saved
        vocabulary, or None."""
        self._drain_pipe()
        self._finish_loop_pending()
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
        self._finish_loop_pending()       # a pending closure lands first
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
        self._drain_pipe()
        with open(path, "w") as f:
            for fid, p in self.trajectory:
                f.write(f"{fid},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f}\n")

    def n_keyframes(self) -> int:
        self._drain_pipe()
        self._finish_loop_pending()
        return int(self.ms.n_kf)

    def n_map_points(self) -> int:
        self._drain_pipe()
        return int(self.ms.mp_valid.sum())
