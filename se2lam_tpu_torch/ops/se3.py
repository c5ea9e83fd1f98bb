"""SE(3) matrix-group operations on batched tensors (port of
se2lam_tpu.ops.se3; reference cvutil SE3 helpers, src/cvutil.cpp:15-43,
and the SO(3)/SE(3) exp/log of src/optimizer.cpp:64-157). Transforms are
(..., 4, 4) homogeneous matrices; twists are (..., 6) ``[rho(3), phi(3)]``
(translation part, rotation part), the JAX package's order. Under a
fleet's ``torch.vmap`` on the card the small products of ``inv`` and
``apply`` take the fixed-order forms of ``ops/fixed_order``.

``torch.where`` evaluates both branches, as JAX's ``where`` does; every
branch that is not taken near 0 (or near π) is guarded, as there, by a
denominator clamped away from zero, so no NaN is formed.
"""
from __future__ import annotations

import torch

from . import fixed_order

__all__ = ["skew", "inv", "apply", "make_rt", "so3_exp", "so3_log", "se3_exp", "se3_log",
           "adjoint"]

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


def so3_log(R):
    """Rotation matrix → axis-angle 3-vector(s). Near θ = 0 and θ = π,
    where sin θ ≤ 1e-6, the scale θ/(2 sin θ) takes its small-angle series
    0.5 + θ²/12, as in the JAX package (ill-conditioned at π, which planar
    SLAM never reaches between covisible keyframes)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # w = 2 sin(theta) * axis
    sin_t = torch.sin(theta)
    scale = torch.where(
        sin_t.abs() > 1e-6,
        theta / torch.clamp(2.0 * sin_t, min=_EPS),
        0.5 + theta * theta / 12.0,
    )
    return scale[..., None] * w


def _so3_left_jacobian(phi):
    """Left Jacobian of SO(3) (reference Jl, src/optimizer.cpp:64-80)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    K = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    small = theta2 > 1e-8
    a = torch.where(
        small,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS),
        0.5 - theta2 / 24.0,
    )
    b = torch.where(
        small,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def se3_exp(xi):
    """Twist [rho, phi] (..., 6) → SE(3) matrix (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = _so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_rt(R, t)


def se3_log(T):
    """SE(3) matrix → twist [rho, phi] (..., 6)."""
    phi = so3_log(T[..., :3, :3])
    V = _so3_left_jacobian(phi)
    rho = torch.linalg.solve(V, T[..., :3, 3][..., :, None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def adjoint(T):
    """Adjoint of SE(3) in [rho, phi] order, (..., 6, 6):
    Ad(T) @ [rho, phi] = [R rho + [t]x R phi, R phi] (g2o SE3Quat::adj()
    up to the block order; src/optimizer.cpp:293)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = skew(t) @ R
    top = torch.cat([R, tR], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)
