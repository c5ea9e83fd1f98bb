"""Factor residuals, analytic Jacobians and information models (port of
se2lam_tpu.factors), batched over leading axes where the JAX package
``vmap``s its per-instance functions:

- SE2-XYZ reprojection factor (reference EdgeSE2XYZ, src/EdgeSE2XYZ.cpp:61-106)
- preintegrated-SE2 odometry factor (reference PreEdgeSE2,
  include/se2lam/EdgeSE2XYZ.h:62-102)
- the marginalized plane-motion measurement covariance for SE2-XYZ edges
  (reference Map::loadLocalGraph, src/Map.cpp:1024-1049)
- SE2 odometry preintegration (reference Track::updateFramePose,
  src/Track.cpp:169-188) and its composition
- anisotropic triangulation information (reference Track::calcSE3toXYZInfo,
  src/Track.cpp:259-306)
"""
from __future__ import annotations

import torch

from .ops import fixed_order, se2, se3
from .ops.camera import CameraModel

__all__ = [
    "se2_to_se3_mat",
    "se2xyz_depth",
    "se2xyz_residual",
    "huber_rho",
    "pixel_jacobian",
    "se2xyz_residual_jac",
    "se2xyz_sigma",
    "pre_se2_residual",
    "pre_se2_residual_jac",
    "preintegrate_se2",
    "compose_preintegration",
    "se3_to_xyz_info",
]


def se2_to_se3_mat(pose):
    """(x,y,theta) → 4x4 SE(3), z=0 rotation about z (g2o SE2ToSE3,
    src/EdgeSE2XYZ.cpp:27)."""
    return se2.to_se3(pose)


def _camera_frame_point(pose, point_w, Tcb):
    """lc = Tcb · SE3(pose⁻¹) · X and Rcw."""
    Tcw = fixed_order.matmul(Tcb, se2.to_se3(se2.inv(pose)))
    return se3.apply(Tcw, point_w), Tcw[..., :3, :3]


def _safe_z(z, eps: float = 1e-4):
    """Clamp |z| away from 0 so behind-camera/degenerate points give large
    but finite residuals (a zero robust weight cannot mask a NaN)."""
    return torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)


def se2xyz_depth(pose, point_w, Tcb):
    """Camera-frame depth of a world point seen from an SE(2) body pose."""
    lc, _ = _camera_frame_point(pose, point_w, Tcb)
    return lc[..., 2]


def _project(lc, cam: CameraModel):
    z = _safe_z(lc[..., 2])
    u = cam.fx * lc[..., 0] / z + cam.cx
    v = cam.fy * lc[..., 1] / z + cam.cy
    return torch.stack([u, v], dim=-1)


def se2xyz_residual(pose, point_w, uv, cam: CameraModel, Tcb):
    """e = π(Tcb · SE3(ξ⁻¹) · X) − uv (EdgeSE2XYZ::computeError,
    src/EdgeSE2XYZ.cpp:61-72)."""
    lc, _ = _camera_frame_point(pose, point_w, Tcb)
    return _project(lc, cam) - uv


def huber_rho(chi2, delta):
    """Huber robust cost: χ² below the kink, 2δ√χ² − δ² above."""
    sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(sqrt_chi > delta, 2.0 * delta * sqrt_chi - delta * delta, chi2)


def _proj_jac_rcw(lc, Rcw, cam: CameraModel):
    """J_π · Rcw (2x3), with fx and fy for the two rows."""
    zinv = 1.0 / _safe_z(lc[..., 2])
    zinv2 = zinv * zinv
    zero = torch.zeros_like(zinv)
    J_pi = torch.stack(
        [
            torch.stack([cam.fx * zinv, zero, -cam.fx * lc[..., 0] * zinv2], -1),
            torch.stack([zero, cam.fy * zinv, -cam.fy * lc[..., 1] * zinv2], -1),
        ],
        dim=-2,
    )
    return fixed_order.matmul(J_pi, Rcw)


def pixel_jacobian(lc, cam: CameraModel):
    """∂(u,v)/∂(camera-frame point): the 2x3 pinhole Jacobian at ``lc``."""
    eye = torch.eye(3, dtype=lc.dtype, device=lc.device).expand(lc.shape[:-1] + (3, 3))
    return _proj_jac_rcw(lc, eye, cam)


def _planar(pose):
    return torch.stack([pose[..., 0], pose[..., 1], torch.zeros_like(pose[..., 0])], dim=-1)


def se2xyz_residual_jac(pose, point_w, uv, cam: CameraModel, Tcb):
    """Residual + analytic Jacobians wrt pose (2x3) and point (2x3)
    (EdgeSE2XYZ::linearizeOplus, src/EdgeSE2XYZ.cpp:75-106)."""
    lc, Rcw = _camera_frame_point(pose, point_w, Tcb)
    r = _project(lc, cam) - uv
    JR = _proj_jac_rcw(lc, Rcw, cam)
    J_theta = fixed_order.matmul(JR, se3.skew(point_w - _planar(pose)))[..., :, 2:3]
    J_pose = torch.cat([-JR[..., :, :2], J_theta], dim=-1)
    return r, J_pose, JR


def se2xyz_sigma(pose, point_w, lc, cam: CameraModel, Tcw, sigma2_uv,
                 sigma_rotxy, sigma_z):
    """2x2 measurement covariance marginalizing out-of-plane motion
    (Map::loadLocalGraph, src/Map.cpp:1024-1046)."""
    JR = _proj_jac_rcw(lc, Tcw[..., :3, :3], cam)
    J_rotxy = (JR @ se3.skew(point_w - _planar(pose)))[..., :2, :2]
    J_z = -JR[..., :, 2:3]
    eye = torch.eye(2, dtype=JR.dtype, device=JR.device)
    return (
        sigma_rotxy * (J_rotxy @ J_rotxy.transpose(-1, -2))
        + sigma_z * (J_z @ J_z.transpose(-1, -2))
        + sigma2_uv[..., None, None] * eye
    )


def pre_se2_residual(pose_i, pose_j, meas):
    """Preintegrated SE2 odometry error (PreEdgeSE2::computeError,
    include/se2lam/EdgeSE2XYZ.h:68-81)."""
    Ri = se2.rot2(pose_i[..., 2])
    rij = pose_j[..., :2] - pose_i[..., :2]
    e_xy = torch.einsum("...ji,...j->...i", Ri, rij) - meas[..., :2]
    e_t = se2.normalize_angle(pose_j[..., 2] - pose_i[..., 2] - meas[..., 2])
    return torch.cat([e_xy, e_t[..., None]], dim=-1)


def pre_se2_residual_jac(pose_i, pose_j, meas):
    """Residual + analytic 3x3 Jacobians (PreEdgeSE2::linearizeOplus,
    include/se2lam/EdgeSE2XYZ.h:82-99)."""
    r = pre_se2_residual(pose_i, pose_j, meas)
    RiT = se2.rot2(pose_i[..., 2]).transpose(-1, -2)
    rij = pose_j[..., :2] - pose_i[..., :2]
    rij_perp = torch.stack([-rij[..., 1], rij[..., 0]], dim=-1)

    Ji = torch.zeros(r.shape[:-1] + (3, 3), dtype=r.dtype, device=r.device)
    Ji[..., :2, :2] = -RiT
    Ji[..., :2, 2] = -torch.einsum("...ij,...j->...i", RiT, rij_perp)
    Ji[..., 2, 2] = -1.0
    Jj = torch.zeros_like(Ji)
    Jj[..., :2, :2] = RiT
    Jj[..., 2, 2] = 1.0
    return r, Ji, Jj


def preintegrate_se2(meas, cov, d_odo, odo_noise):
    """One SE2 preintegration step (Track::updateFramePose,
    src/Track.cpp:169-188).

    meas (..., 3), cov (..., 3, 3): accumulated relative measurement and
    covariance. d_odo (..., 3): raw odometry delta this step.
    odo_noise (..., 3): per-step noise std (x, y, theta).
    Returns updated (meas, cov).
    """
    Phi = se2.rot2(meas[..., 2])
    dr = d_odo[..., :2]
    new_xy = meas[..., :2] + torch.einsum("...ij,...j->...i", Phi, dr)
    new_t = meas[..., 2] + d_odo[..., 2]
    new_meas = torch.cat([new_xy, new_t[..., None]], dim=-1)

    eye = torch.eye(3, dtype=meas.dtype, device=meas.device)
    dr_perp = torch.stack([-dr[..., 1], dr[..., 0]], dim=-1)
    # made from cov, so that under a vmap over robots they are batched and
    # take the batched writes
    Ak = torch.zeros_like(cov) + eye
    Ak[..., :2, 2] = torch.einsum("...ij,...j->...i", Phi, dr_perp)
    Bk = torch.zeros_like(cov) + eye
    Bk[..., :2, :2] = Phi
    Sigma_v = torch.diag_embed(odo_noise**2).expand(cov.shape)
    new_cov = (
        Ak @ cov @ Ak.transpose(-1, -2)
        + Bk @ Sigma_v @ Bk.transpose(-1, -2)
    )
    return new_meas, new_cov


def compose_preintegration(meas_a, cov_a, meas_b, cov_b):
    """Chain two preintegrated SE2 segments a→b→c into one a→c: meas =
    meas_a ⊕ meas_b, cov = A Σa Aᵀ + B Σb Bᵀ (used when pruning splices a
    keyframe's two odometry edges, Map::pruneRedundantKF,
    src/Map.cpp:222-257)."""
    Phi = se2.rot2(meas_a[..., 2])
    drb = meas_b[..., :2]
    new_xy = meas_a[..., :2] + torch.einsum("...ij,...j->...i", Phi, drb)
    new_t = meas_a[..., 2] + meas_b[..., 2]
    new_meas = torch.cat([new_xy, new_t[..., None]], dim=-1)

    eye = torch.eye(3, dtype=meas_a.dtype, device=meas_a.device)
    drb_perp = torch.stack([-drb[..., 1], drb[..., 0]], dim=-1)
    A = eye.expand(cov_a.shape).clone()
    A[..., :2, 2] = torch.einsum("...ij,...j->...i", Phi, drb_perp)
    B = eye.expand(cov_a.shape).clone()
    B[..., :2, :2] = Phi
    new_cov = A @ cov_a @ A.transpose(-1, -2) + B @ cov_b @ B.transpose(-1, -2)
    return new_meas, new_cov


def _rotation_aligning_z(xyz):
    """Rodrigues rotation taking the camera z-axis onto the ray ``xyz``
    (the k-vector construction of Track::calcSE3toXYZInfo,
    src/Track.cpp:286-301)."""
    length = torch.linalg.norm(xyz, dim=-1)
    z_axis = torch.zeros_like(xyz)
    z_axis[..., 2] = length
    k = torch.linalg.cross(xyz, z_axis, dim=-1)
    normk = torch.linalg.norm(k, dim=-1)
    sin_a = normk / torch.clamp(length * length, min=1e-12)
    angle = torch.arcsin(torch.clamp(sin_a, -1.0, 1.0))
    axis = k * (angle / torch.clamp(normk, min=1e-12))[..., None]
    return se3.so3_exp(axis)


def se3_to_xyz_info(xyz1, Tcw1, Tcw2, fx):
    """Anisotropic 3x3 information of a triangulated point in both camera
    frames (Track::calcSE3toXYZInfo, src/Track.cpp:259-306): tight in the
    image plane, loose along the viewing ray, scaled by parallax.
    Returns (info1, info2)."""
    Twc1 = se3.inv(Tcw1)
    o1 = Twc1[..., :3, 3]
    o2 = se3.inv(Tcw2)[..., :3, 3]
    xyz_w = se3.apply(Twc1, xyz1)
    v1 = xyz_w - o1
    v2 = xyz_w - o2
    sin_parallax = torch.linalg.norm(torch.linalg.cross(v1, v2, dim=-1), dim=-1) / torch.clamp(
        torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1), min=1e-12
    )
    sin_parallax = torch.clamp(sin_parallax, min=1e-6)

    xyz2 = se3.apply(Tcw2, xyz_w)
    dxy1 = 2.0 * torch.linalg.norm(xyz1, dim=-1) / fx
    dxy2 = 2.0 * torch.linalg.norm(xyz2, dim=-1) / fx
    dz1 = dxy2 / sin_parallax
    dz2 = dxy1 / sin_parallax

    def diag_info(dxy, dz):
        d = torch.stack([1.0 / (dxy * dxy), 1.0 / (dxy * dxy), 1.0 / (dz * dz)], dim=-1)
        return torch.diag_embed(d)

    R1 = _rotation_aligning_z(xyz1)
    R2 = _rotation_aligning_z(xyz2)
    info1 = R1.transpose(-1, -2) @ diag_info(dxy1, dz1) @ R1
    info2 = R2.transpose(-1, -2) @ diag_info(dxy2, dz2) @ R2
    return info1, info2
