"""Factor helpers used by tracking (port of the parts of se2lam_tpu.factors
that the tracking step runs): SE2 odometry preintegration (reference
Track::updateFramePose, src/Track.cpp:169-188) and the SE2 → SE3 lift.
"""
from __future__ import annotations

import torch

from .ops import se2

__all__ = ["se2_to_se3_mat", "preintegrate_se2"]


def se2_to_se3_mat(pose):
    """(x,y,theta) → 4x4 SE(3), z=0 rotation about z (g2o SE2ToSE3,
    src/EdgeSE2XYZ.cpp:27)."""
    return se2.to_se3(pose)


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
    Ak = eye.expand(cov.shape).clone()
    Ak[..., :2, 2] = torch.einsum("...ij,...j->...i", Phi, dr_perp)
    Bk = eye.expand(cov.shape).clone()
    Bk[..., :2, :2] = Phi
    Sigma_v = torch.diag_embed(odo_noise**2).expand(cov.shape)
    new_cov = (
        Ak @ cov @ Ak.transpose(-1, -2)
        + Bk @ Sigma_v @ Bk.transpose(-1, -2)
    )
    return new_meas, new_cov
