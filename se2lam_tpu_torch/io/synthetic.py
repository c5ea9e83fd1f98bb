"""Synthetic ground-rover world for end-to-end tests and benchmarks (the
port's own numpy copy of se2lam_tpu.io.synthetic: the same seed renders
the same frames).

The reference validates end-to-end behavior only on its (undistributed)
DatasetRoom recording, by eye in rviz (SURVEY §4). This module replaces
that with a reproducible generator: textured landmarks on the walls of a
rectangular room, a ground-truth SE(2) trajectory, rendered grayscale
frames, and odometry readings with configurable drift/noise — so ATE can
be measured against exact ground truth.
"""
from __future__ import annotations

import numpy as np

__all__ = ["SyntheticWorld", "map_gauge"]


class SyntheticWorld:
    """Rectangular room with textured point landmarks on the walls.

    Camera looks along body +x (standard rover rig: body x forward,
    camera z forward), intrinsics from ``cfg``.
    """

    def __init__(
        self,
        cfg,
        n_landmarks: int = 600,
        room: float = 10.0,
        seed: int = 0,
        patch: int = 9,
    ):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        self.room = room
        h = room / 2
        # landmarks on 4 walls at heights around camera level
        n4 = n_landmarks // 4
        walls = []
        for wall in range(4):
            u = rng.uniform(-h, h, n4)
            z = rng.uniform(-1.0, 1.5, n4)
            if wall == 0:
                pts = np.stack([np.full(n4, h), u, z], -1)
            elif wall == 1:
                pts = np.stack([np.full(n4, -h), u, z], -1)
            elif wall == 2:
                pts = np.stack([u, np.full(n4, h), z], -1)
            else:
                pts = np.stack([u, np.full(n4, -h), z], -1)
            walls.append(pts)
        self.landmarks = np.concatenate(walls)  # (L, 3) world
        L = len(self.landmarks)
        # fixed random texture patch per landmark → distinctive descriptors
        self.patches = rng.uniform(40, 255, (L, patch, patch)).astype(
            np.float32
        )
        self.patch = patch
        self.Tcb = np.array(
            [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
            np.float64,
        )
        self._rng = rng

    # -- trajectories --

    def circle_trajectory(self, n_frames: int, radius: float = 2.5):
        """Poses looping a circle inside the room: (n, 3) (x, y, theta)."""
        ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
        x = radius * np.cos(ts)
        y = radius * np.sin(ts)
        theta = ts + np.pi / 2  # tangent heading
        theta = np.arctan2(np.sin(theta), np.cos(theta))
        return np.stack([x, y, theta], -1).astype(np.float32)

    def odometry(self, gt_poses, noise=(0.0, 0.0, 0.0), seed: int = 1):
        """Odometry readings: integrate noisy relative motions.

        noise: per-step std of (x, y, theta) relative-motion error —
        produces realistic drift, not per-reading jitter.
        """
        rng = np.random.default_rng(seed)
        n = len(gt_poses)
        odo = np.zeros_like(gt_poses)
        odo[0] = gt_poses[0]
        for k in range(1, n):
            d = _se2_minus(gt_poses[k], gt_poses[k - 1])
            d = d + rng.normal(0, noise, 3).astype(np.float32)
            odo[k] = _se2_plus(odo[k - 1], d)
        return odo

    # -- rendering --

    def render(self, pose) -> np.ndarray:
        """Render one grayscale frame (H, W) float32 at an SE(2) body pose.

        Applies the config's radial-tangential distortion to the projected
        positions, so runs with ``cfg.dist != 0`` exercise the keypoint
        undistortion path end-to-end."""
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        Twb = _se2_mat(pose)
        Tcw = self.Tcb @ np.linalg.inv(Twb)
        pc = (Tcw[:3, :3] @ self.landmarks.T).T + Tcw[:3, 3]
        z = pc[:, 2]
        vis = z > 0.3
        xn = pc[:, 0] / np.where(vis, z, 1.0)
        yn = pc[:, 1] / np.where(vis, z, 1.0)
        if any(abs(d) > 0 for d in cfg.dist):
            # the SAME model the system inverts (ops/camera.py) — a
            # re-implementation here could silently drift from it. Frames
            # are rendered on the host, so the model runs on CPU tensors.
            import torch

            from ..ops.camera import CameraModel, distort_normalized

            cam = CameraModel.create(
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist, device="cpu"
            )
            xy = distort_normalized(
                cam, torch.from_numpy(np.stack([xn, yn], -1).astype(np.float32))
            ).numpy()
            xn, yn = xy[:, 0], xy[:, 1]
        u = cfg.fx * xn + cfg.cx
        v = cfg.fy * yn + cfg.cy
        p = self.patch
        r = p // 2
        vis &= (u >= r + 1) & (u < W - r - 1) & (v >= r + 1) & (v < H - r - 1)

        img = np.full((H, W), 20.0, np.float32)
        for i in np.nonzero(vis)[0]:
            # bilinear splat at the subpixel position — snapping to integer
            # pixels would quantize the visual world itself by ±0.5 px and
            # put a floor under any tracker's achievable accuracy
            u0, v0 = int(np.floor(u[i])), int(np.floor(v[i]))
            fu, fv = u[i] - u0, v[i] - v0
            p = self.patches[i]
            for dy, wy in ((0, 1.0 - fv), (1, fv)):
                for dx, wx in ((0, 1.0 - fu), (1, fu)):
                    w = wy * wx
                    if w < 1e-6:
                        continue
                    cy, cx = v0 + dy, u0 + dx
                    img[cy - r : cy + r + 1, cx - r : cx + r + 1] += w * (
                        p - 20.0
                    )
        return np.clip(img, 0.0, 255.0)

    def sequence(self, n_frames: int, noise=(0.002, 0.001, 0.001), seed=1):
        """Yield (image, odo_reading) pairs plus keep gt in ``self.gt``."""
        self.gt = self.circle_trajectory(n_frames)
        odo = self.odometry(self.gt, noise, seed)
        for k in range(n_frames):
            yield self.render(self.gt[k]), odo[k]


def map_gauge(gt):
    """Ground-truth positions in the gauge of a map built from ``gt[0]``:
    ``se2.minus(gt[i], gt[0])[:2]``, as (n, 2)."""
    d = gt[:, :2] - gt[0, :2]
    c, s = np.cos(gt[0, 2]), np.sin(gt[0, 2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], 1)


def _se2_mat(p):
    c, s = np.cos(p[2]), np.sin(p[2])
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[0, 3], T[1, 3] = p[0], p[1]
    return T


def _se2_minus(a, b):
    dx, dy = a[0] - b[0], a[1] - b[1]
    c, s = np.cos(b[2]), np.sin(b[2])
    dt = np.arctan2(np.sin(a[2] - b[2]), np.cos(a[2] - b[2]))
    return np.asarray([c * dx + s * dy, -s * dx + c * dy, dt], np.float32)


def _se2_plus(a, d):
    c, s = np.cos(a[2]), np.sin(a[2])
    th = np.arctan2(np.sin(a[2] + d[2]), np.cos(a[2] + d[2]))
    return np.asarray(
        [a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], th],
        np.float32,
    )
