"""Localization against a saved map: ``se2lam_tpu_torch.localizer.Localizer``
fed frame by frame through ``process(img, odo)`` (None while lost).

Set-up renders the mapping lap and the route's lap, maps the mapping lap
with ``SlamSystem`` at the same configuration, saves the map with
``save_map`` and loads it back with ``load_map``, as a user loads a map
from disk, then runs a throwaway Localizer over the first frames (a cold
start's relocalization and tracked steps). Where the mix restarts the
robot, a fresh Localizer is built before each jumped frame. After the
window the run is judged by the extraction of a sample of its frames
against the plain extractor, a sample of K2's launches against the plain
gated top-2, a sample of the pose-only solves against a float64 re-solve
from the same inputs (on a tracked frame, the pose the frame returned),
and the localized poses against the ground truth.
"""
from __future__ import annotations

import tempfile

import numpy as np
import torch

from ..reference.geometry import pose_only
from ..reference.match import rows_differing, windowed_top2
from ..world import map_gauge
from .common import Session, extraction_diff

__all__ = ["LocalizerSession"]


class LocalizerSession(Session):
    DRAW_FROM, SAMPLES = 120, 6

    def build(self):
        from se2lam_tpu_torch.io import load_map
        from se2lam_tpu_torch.localizer import Localizer
        from se2lam_tpu_torch.system import SlamSystem

        self._Localizer = Localizer
        seq = self.seq
        slam = SlamSystem(self.cfg, device=self.device, generator=self.torch_generator(3))
        slam._loop_closer.generator = self.torch_generator(4)
        for p, o in zip(seq.map_gt, seq.map_odo):
            slam.process(self.world.render_uint8(p), o)
        self.map_keyframes = len(slam.kf_frame_ids)
        self.map_points = slam.n_map_points()
        with tempfile.TemporaryDirectory() as d:
            slam.save_map(d)
            del slam
            self.ms, self.vocab, _ = load_map(d, device=self.device)
        self._reset()
        self.system = self._new(salt=5)
        for i in range(self.traffic.warm_frames):
            self.process(i)
        del self.system

    def _reset(self):
        self.tracked = {}                  # window frame -> tracked by the step
        self.retired = dict(localized=0, tracked=0, frames=0, host_reads=0)
        self.restarts = 0

    def _retire(self):
        """Add a Localizer's counts to those of the ones before it."""
        tr = self.system.trajectory
        for k, v in dict(localized=sum(p is not None for _, p, _ in tr),
                         tracked=sum(bool(t) for _, _, t in tr), frames=len(tr),
                         host_reads=self.system.host_reads).items():
            self.retired[k] += v

    def _new(self, salt):
        return self._Localizer(self.cfg, self.ms, self.vocab, device=self.device,
                               generator=self.torch_generator(salt))

    def start(self):
        self._reset()
        self.system = self._new(salt=1)

    def holds(self, n_frames):
        """K2 launches and pose-only solves (about one a frame) drawn from
        the window's first ``DRAW_FROM``, or its ``n_frames``."""
        r = self.rng(11)
        n = min(self.DRAW_FROM, n_frames)
        pick = lambda: {0} | set(r.choice(n, min(self.SAMPLES, n), replace=False).tolist())
        return {"k2": ("se2lam_tpu_torch.frontend.windowed_match:windowed_top2", pick()),
                "pose_only": ("se2lam_tpu_torch.localizer:solve_pose_only", pick())}

    def process(self, i):
        if self.traffic.restart and self.seq.jumps[i]:
            self._retire()
            self.restarts += 1
            self.system = self._new(salt=100 + i)
        pose = self.system.process(self.image(i), self.seq.odo[i])
        self.tracked[i] = bool(self.system.trajectory[-1][2])
        return pose

    def counts(self):
        self._retire()
        c = dict(self.retired, restarts=self.restarts, map_keyframes=self.map_keyframes,
                 map_points=self.map_points)
        self.retired = dict.fromkeys(self.retired, 0)
        return c

    def unchanged(self, n_done):
        """``loc_err_p90_m`` of a localizer whose pose never leaves the
        window's first frame's."""
        gt = map_gauge(self.seq.gt[:n_done], self.seq.map_gt[0])
        return dict(loc_err_p90_m=float(np.percentile(np.linalg.norm(gt - gt[0], axis=1), 90)))

    def readings(self, n_done, poses, held, extracted, tf32=False):
        """The numbers compared: ``extract_diff``, ``k2_rows``,
        ``pose_gap_m``, ``loc_err_p90_m``. ``pose_gap_m`` measures, at a
        tracked frame, the pose that the frame returned (the solve's
        result, as the user gets it), and at a relocalization the
        refinement's result. ``tf32``: the control, the references in the
        precision below (TF32 products, a float16 window test, a bfloat16
        solve)."""
        gt = map_gauge(self.seq.gt[:n_done], self.seq.map_gt[0])
        errs = [float(np.linalg.norm(np.asarray(p[:2], np.float64) - g))
                for p, g in zip(poses[:n_done], gt) if p is not None]
        loc_err = float(np.percentile(errs, 90)) if errs else float("inf")
        k2 = 0
        for _i, args, _kw, out in held["k2"].kept:
            want = windowed_top2(*args)
            got = windowed_top2(*args, gate_dtype=torch.float16) if tf32 else out
            k2 += rows_differing(got, want)
        sc = self.doc["system"]
        K = (sc["fx"], sc["fy"], sc["cx"], sc["cy"])
        gaps = []
        hold = held["pose_only"]
        for (_i, args, kw, out), frame in zip(hold.kept, hold.tags):
            pose, points, uv, valid = args[:4]
            iters = kw.get("iters", args[6] if len(args) > 6 else 30)
            want = pose_only(pose, points, uv, valid, K, self.tcb(), iters=iters)
            if tf32:
                got = pose_only(pose, points, uv, valid, K, self.tcb(), iters=iters,
                                dtype=torch.bfloat16)
            elif self.tracked.get(frame) and frame < n_done and poses[frame] is not None:
                got = torch.as_tensor(np.asarray(poses[frame]), device=want.device)
            else:
                got = out[0]
            gaps.append(float((got.to(torch.float64)[:2] - want[:2]).norm()))
        return dict(extract_diff=extraction_diff(self, extracted, tf32), k2_rows=k2,
                    pose_gap_m=max(gaps) if gaps else float("inf"), loc_err_p90_m=loc_err)
