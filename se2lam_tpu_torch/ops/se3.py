"""SE(3) matrix-group operations on batched tensors (port of the parts of
se2lam_tpu.ops.se3 that tracking uses; reference cvutil SE3 helpers,
src/cvutil.cpp:15-43). Transforms are (..., 4, 4) homogeneous matrices.
Under a fleet's ``torch.vmap`` on the card their small products take the
fixed-order forms of ``ops/fixed_order``.
"""
from __future__ import annotations

import torch

from . import fixed_order

__all__ = ["skew", "inv", "apply", "make_rt", "so3_exp"]

_EPS = 1e-8


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
    return make_rt(Rt, -fixed_order.contract("...ij,...j->...i", Rt, t, fixed_order.rows_matvec))


def apply(T, pt):
    """Transform 3D point(s): R·p + t (reference cvu::se3map, src/cvutil.cpp:100)."""
    R = T[..., :3, :3]
    return fixed_order.contract("...ij,...j->...i", R, pt, fixed_order.rows_matvec) + T[..., :3, 3]


def so3_exp(phi):
    """Rodrigues: axis-angle 3-vector(s) → rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.sinc(theta / torch.pi)  # sin(theta)/theta
    b = torch.where(
        theta2 > 1e-8,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS),
        0.5 - theta2 / 24.0,
    )
    K = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)
