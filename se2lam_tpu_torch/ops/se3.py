"""SE(3) matrix-group operations on batched tensors (port of the parts of
se2lam_tpu.ops.se3 that tracking uses; reference cvutil SE3 helpers,
src/cvutil.cpp:15-43). Transforms are (..., 4, 4) homogeneous matrices.
"""
from __future__ import annotations

import torch

__all__ = ["skew", "inv", "apply", "make_rt"]


def skew(v):
    """Skew-symmetric matrix/matrices of 3-vector(s). Shape (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    rows = [
        torch.stack([o, -z, y], dim=-1),
        torch.stack([z, o, -x], dim=-1),
        torch.stack([-y, x, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def make_rt(R, t):
    """Assemble (..., 4, 4) from rotation (..., 3, 3) and translation (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inv(T):
    """Fast SE(3) inverse: [Rᵀ, -Rᵀt] (reference cvu::inv, src/cvutil.cpp:15)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def apply(T, pt):
    """Transform 3D point(s): R·p + t (reference cvu::se3map, src/cvutil.cpp:100)."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], pt) + T[..., :3, 3]
