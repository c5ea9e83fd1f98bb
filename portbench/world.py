"""The benchmark's synthetic room: a frozen numpy copy of the port's
``se2lam_tpu_torch/io/synthetic.py`` (no distortion), kept here so that no
change to the program can move the frames or the ground truth it is
measured on. ``portbench/tests/test_world.py`` holds it bitwise to the
port's renderer at a seed.

Textured point landmarks on the four walls of a square room, a circular
ground-truth SE(2) route, grayscale frames rendered by bilinear splats of
each landmark's patch, and odometry integrated from noisy relative motions.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Camera", "World", "se2_minus", "se2_plus", "map_gauge"]

TCB = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)


class Camera:
    """Pinhole intrinsics and image size (no distortion)."""

    def __init__(self, width, height, fx, fy, cx, cy):
        self.width, self.height = int(width), int(height)
        self.fx, self.fy, self.cx, self.cy = float(fx), float(fy), float(cx), float(cy)


class World:
    """Square room of side ``room`` with ``n_landmarks`` textured points on
    its walls, drawn from ``seed`` in the port's order."""

    def __init__(self, cam: Camera, n_landmarks: int, room: float, seed: int, patch: int = 9):
        self.cam = cam
        rng = np.random.default_rng(seed)
        h = room / 2
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
        self.landmarks = np.concatenate(walls)
        self.patches = rng.uniform(40, 255, (len(self.landmarks), patch, patch)).astype(np.float32)
        self.patch = patch

    def render(self, pose) -> np.ndarray:
        """(H, W) float32 frame at an SE(2) body pose (x, y, theta)."""
        cam = self.cam
        H, W = cam.height, cam.width
        Tcw = TCB @ np.linalg.inv(_se2_mat(pose))
        pc = (Tcw[:3, :3] @ self.landmarks.T).T + Tcw[:3, 3]
        z = pc[:, 2]
        vis = z > 0.3
        xn = pc[:, 0] / np.where(vis, z, 1.0)
        yn = pc[:, 1] / np.where(vis, z, 1.0)
        u = cam.fx * xn + cam.cx
        v = cam.fy * yn + cam.cy
        r = self.patch // 2
        vis &= (u >= r + 1) & (u < W - r - 1) & (v >= r + 1) & (v < H - r - 1)
        img = np.full((H, W), 20.0, np.float32)
        for i in np.nonzero(vis)[0]:
            u0, v0 = int(np.floor(u[i])), int(np.floor(v[i]))
            fu, fv = u[i] - u0, v[i] - v0
            p = self.patches[i]
            for dy, wy in ((0, 1.0 - fv), (1, fv)):
                for dx, wx in ((0, 1.0 - fu), (1, fu)):
                    w = wy * wx
                    if w < 1e-6:
                        continue
                    cy, cx = v0 + dy, u0 + dx
                    img[cy - r: cy + r + 1, cx - r: cx + r + 1] += w * (p - 20.0)
        return np.clip(img, 0.0, 255.0)

    def render_uint8(self, pose) -> np.ndarray:
        """The frame as a camera driver hands it over: rounded to uint8."""
        return np.rint(self.render(pose)).astype(np.uint8)


def circle(n_frames: int, radius: float, phase: float = 0.0) -> np.ndarray:
    """(n, 3) float32 poses on a circle about the room's centre, heading
    along the tangent, starting ``phase`` frames' arc along it."""
    ts = (np.arange(n_frames) + phase) * (2 * np.pi / n_frames)
    theta = np.arctan2(np.sin(ts + np.pi / 2), np.cos(ts + np.pi / 2))
    return np.stack([radius * np.cos(ts), radius * np.sin(ts), theta], -1).astype(np.float32)


def odometry(steps, start, noise, rng) -> np.ndarray:
    """Odometry readings from ``start`` integrating the relative motions
    ``steps`` (n, 3) with per-step Gaussian error of std ``noise``."""
    odo = np.zeros((len(steps) + 1, 3), np.float32)
    odo[0] = start
    for k, d in enumerate(steps):
        odo[k + 1] = se2_plus(odo[k], d + rng.normal(0, noise, 3).astype(np.float32))
    return odo


def map_gauge(gt, origin) -> np.ndarray:
    """Ground-truth positions in the gauge of a map whose first keyframe
    sits at ``origin``: ``se2_minus(gt[i], origin)[:2]``, as (n, 2)."""
    d = gt[:, :2] - origin[:2]
    c, s = np.cos(origin[2]), np.sin(origin[2])
    return np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], 1)


def _se2_mat(p):
    c, s = np.cos(p[2]), np.sin(p[2])
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[0, 3], T[1, 3] = p[0], p[1]
    return T


def se2_minus(a, b):
    """b⁻¹ ∘ a: the motion from pose b to pose a in b's frame."""
    dx, dy = a[0] - b[0], a[1] - b[1]
    c, s = np.cos(b[2]), np.sin(b[2])
    dt = np.arctan2(np.sin(a[2] - b[2]), np.cos(a[2] - b[2]))
    return np.asarray([c * dx + s * dy, -s * dx + c * dy, dt], np.float32)


def se2_plus(a, d):
    """a ∘ d."""
    c, s = np.cos(a[2]), np.sin(a[2])
    th = np.arctan2(np.sin(a[2] + d[2]), np.cos(a[2] + d[2]))
    return np.asarray([a[0] + c * d[0] - s * d[1], a[1] + s * d[0] + c * d[1], th], np.float32)
