"""Loop-constraint sparsification: 2-KF + M-points Schur marginalization
(port of se2lam_tpu.solver.sparsifier; reference Sparsifier,
src/sparsifier.cpp:105-274).

A verified loop pair's 2-keyframe + M-point subgraph is compressed into
one relative SE(2) constraint: the points are Schur-marginalized out of
the Hessian over (pose_j, points) with pose_i fixed, the conditional
information of pose_j is transported onto the relative measurement, and
its eigenvalues are clamped. The one-pose Schur product is a torch einsum,
as the JAX package computes it outside any kernel; the clamp is
``torch.linalg.eigh`` (a library solver there too).
"""
from __future__ import annotations

import torch

from .. import factors
from ..ops import linalg, se2
from ..ops.camera import CameraModel

__all__ = ["marginalize_pair_constraint"]


def marginalize_pair_constraint(
    pose_i,
    pose_j,
    points,          # (M, 3) world positions of the shared map points
    uv_i,            # (M, 2) measurements in KF i
    uv_j,            # (M, 2) measurements in KF j
    obs_valid,       # (M,) bool
    cam: CameraModel,
    Tcb,
    sigma2_uv=1.0,
    clamp=(1e-6, 1e4),
):
    """Relative SE2 constraint (meas, info) from a verified loop pair.

    Treats KF i as fixed (the reference's OptKFPairMatch gauge), computes
    the conditional information of pose j after marginalizing the shared
    points, and transports it onto the relative measurement
    ξ = pose_j ⊖ pose_i through the relative factor's Jacobian."""
    dtype, dev = pose_i.dtype, pose_i.device
    w = obs_valid.to(dtype) * (1.0 / sigma2_uv)

    _, Jpj, Jxj = factors.se2xyz_residual_jac(pose_j, points, uv_j, cam, Tcb)
    _, _, Jxi = factors.se2xyz_residual_jac(pose_i, points, uv_i, cam, Tcb)

    # H over (pose_j, points) with pose_i fixed:
    #   Hjj = Σ Jpjᵀ W Jpj, Hjx[m] = Jpj[m]ᵀ W Jxj[m],
    #   Hxx[m] = Jxi[m]ᵀ W Jxi[m] + Jxj[m]ᵀ W Jxj[m]
    Hjj = torch.einsum("mab,m,mac->bc", Jpj, w, Jpj)
    Hjx = torch.einsum("mab,m,mac->mbc", Jpj, w, Jxj)
    Hxx = (torch.einsum("mab,m,mac->mbc", Jxi, w, Jxi)
           + torch.einsum("mab,m,mac->mbc", Jxj, w, Jxj))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hxx_inv = linalg.inv3x3(Hxx + 1e-8 * eye3[None])

    # Schur: conditional information of pose_j (DoMarginalizeSE3XYZ,
    # src/sparsifier.cpp:149-170)
    Hjj_marg = Hjj - torch.einsum("mab,mbc,mdc->ad", Hjx, Hxx_inv, Hjx)

    # transport onto the relative measurement: info_rel = Jj⁻ᵀ Hjj_marg Jj⁻¹
    meas = se2.minus(pose_j, pose_i)
    _, _, Jj = factors.pre_se2_residual_jac(pose_i, pose_j, meas)
    Jj_inv = linalg.inv3x3(Jj)
    info = Jj_inv.T @ Hjj_marg @ Jj_inv

    # symmetrize + eigenvalue clamp (InfoSE3, src/sparsifier.cpp:239-263);
    # an eigenvector's sign cancels in the reconstruction
    info = 0.5 * (info + info.T)
    evals, evecs = torch.linalg.eigh(info)
    evals = torch.clamp(evals, clamp[0], clamp[1])
    info = (evecs * evals[None, :]) @ evecs.T
    # the f32 reconstruction carries ~eps·λmax of absolute noise, which can
    # push the floor eigenvalues negative again (the reference clamps in
    # f64); a diagonal shift of that size restores positive definiteness
    shift = clamp[0] + 8.0 * torch.finfo(info.dtype).eps * evals.max()
    return meas, 0.5 * (info + info.T) + shift * eye3
