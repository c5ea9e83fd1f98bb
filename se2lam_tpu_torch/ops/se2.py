"""SE(2) group operations on batched tensors (port of se2lam_tpu.ops.se2;
reference ``Se2`` algebra, src/Config.cpp:193-245).

Poses are tensors whose last dimension is 3: ``(x, y, theta)``. All ops
broadcast over leading dimensions.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "normalize_angle",
    "compose",
    "inv",
    "minus",
    "to_se3",
    "from_se3",
    "rot2",
    "apply",
]


def normalize_angle(theta):
    """Wrap angle(s) to [-pi, pi) — note +pi maps to -pi."""
    return theta - 2.0 * math.pi * torch.floor((theta + math.pi) / (2.0 * math.pi))


def rot2(theta):
    """2x2 rotation matrix/matrices for angle(s). Shape (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def compose(a, b):
    """Group composition a ∘ b (reference Se2::operator+, src/Config.cpp:205)."""
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bt = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(at), torch.sin(at)
    return torch.stack(
        [
            ax + bx * c - by * s,
            ay + bx * s + by * c,
            normalize_angle(at + bt),
        ],
        dim=-1,
    )


def inv(a):
    """Group inverse (reference Se2::inv, src/Config.cpp:198)."""
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    return torch.stack(
        [-c * x - s * y, s * x - c * y, normalize_angle(-t)], dim=-1
    )


def minus(a, b):
    """Relative pose b⁻¹ ∘ a (reference Se2::operator-, src/Config.cpp:215)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dt = normalize_angle(a[..., 2] - b[..., 2])
    c, s = torch.cos(b[..., 2]), torch.sin(b[..., 2])
    return torch.stack([c * dx + s * dy, -s * dx + c * dy, dt], dim=-1)


def to_se3(a):
    """SE(2) → 4x4 homogeneous SE(3) matrix, rotation about z
    (reference Se2::toCvSE3, src/Config.cpp:225). Shape (..., 4, 4)."""
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    rows = [
        torch.stack([c, -s, z, x], dim=-1),
        torch.stack([s, c, z, y], dim=-1),
        torch.stack([z, z, o, z], dim=-1),
        torch.stack([z, z, z, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def from_se3(T):
    """4x4 SE(3) matrix → (x, y, yaw) (reference Se2::fromCvSE3,
    src/Config.cpp:238)."""
    yaw = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.stack(
        [T[..., 0, 3], T[..., 1, 3], normalize_angle(yaw)], dim=-1
    )


def apply(a, pt):
    """Transform 2D point(s) by SE(2) pose(s). pt shape (..., 2)."""
    x, y, t = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    px, py = pt[..., 0], pt[..., 1]
    return torch.stack([x + c * px - s * py, y + s * px + c * py], dim=-1)
