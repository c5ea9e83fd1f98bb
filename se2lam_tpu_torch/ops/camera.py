"""Pinhole camera model: projection, distortion, undistortion (port of
se2lam_tpu.ops.camera). Features are extracted on the raw image and their
coordinates undistorted; projection matches cvu::camprjc
(src/cvutil.cpp:86).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

__all__ = ["CameraModel", "project", "distort_normalized", "undistort_points"]


class CameraModel(NamedTuple):
    """Camera intrinsics as 0-d tensors; dist = (k1, k2, p1, p2, k3)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,)

    @staticmethod
    def create(fx, fy, cx, cy, dist=None, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        d = torch.zeros(5, dtype=dtype, device=dev)
        if dist is not None:
            dv = torch.as_tensor(dist, dtype=dtype).reshape(-1)
            d[: dv.shape[0]] = dv.to(dev)

        def s(v):
            return torch.as_tensor(v, dtype=dtype).to(dev)

        return CameraModel(s(fx), s(fy), s(cx), s(cy), d)

    @property
    def K(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], -1),
                torch.stack([z, self.fy, self.cy], -1),
                torch.stack([z, z, o], -1),
            ],
            dim=-2,
        )


def project(cam: CameraModel, pts_c):
    """Project camera-frame 3D point(s) (..., 3) to pixels (..., 2), without
    distortion (cvu::camprjc, src/cvutil.cpp:86)."""
    z = pts_c[..., 2]
    inv_z = 1.0 / z
    u = cam.fx * pts_c[..., 0] * inv_z + cam.cx
    v = cam.fy * pts_c[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def distort_normalized(cam: CameraModel, xy):
    """Apply radial-tangential distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(cam: CameraModel, uv, iters: int = 20):
    """Undistort pixel coords (..., 2) → undistorted pixel coords, by the
    fixed-point iteration of cv::undistortPoints with a fixed count."""
    f = torch.stack([cam.fx, cam.fy], dim=-1)
    c = torch.stack([cam.cx, cam.cy], dim=-1)
    xy_d = (uv - c) / f
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (distort_normalized(cam, xy) - xy)
    return xy * f + c
