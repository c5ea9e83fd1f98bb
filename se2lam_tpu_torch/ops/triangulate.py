"""Batched two-view DLT triangulation and parallax tests (port of
se2lam_tpu.ops.triangulate; cvu::triangulate / cvu::checkParallax,
src/cvutil.cpp:46-98). Inhomogeneous DLT through 3x3 normal equations and
a closed-form adjugate, no eigendecomposition.
"""
from __future__ import annotations

import torch

from .fixed_order import contract, matmul, rows_vecmat

__all__ = ["triangulate", "check_parallax", "parallax_cos"]

# cos thresholds for 1..4 degrees of minimum parallax
# (reference minCos table, src/cvutil.cpp:93)
_MIN_COS = (0.9998, 0.9994, 0.9986, 0.9976)


def triangulate(pt1, pt2, P1, P2):
    """DLT triangulation.

    pt1, pt2: (..., 2) pixel coords in views 1/2.
    P1, P2:   (..., 3, 4) projection matrices (K [R|t]).
    Returns (..., 3) points in the frame the P matrices map from.
    """
    rows = [
        pt1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        pt1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        pt2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        pt2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # (..., 4, 4)
    # w := 1: least squares B·x ≈ -c with B = A[:, :3], c = A[:, 3]
    B = A[..., :3]
    c = A[..., 3]
    # (a fleet's vmap sums them in one order at any fleet size: fixed_order)
    M = matmul(B.transpose(-1, -2), B)                # (..., 3, 3)
    rhs = -contract("...ij,...i->...j", B, c,         # (..., 3)
                    lambda B, c: rows_vecmat(c, B))

    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    # degenerate (zero-parallax) systems → huge-depth point, rejected by
    # the callers' depth gate
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    inv_det = 1.0 / det
    x = torch.stack(
        [
            c00 * rhs[..., 0] + c01 * rhs[..., 1] + c02 * rhs[..., 2],
            c01 * rhs[..., 0] + c11 * rhs[..., 1] + c12 * rhs[..., 2],
            c02 * rhs[..., 0] + c12 * rhs[..., 1] + c22 * rhs[..., 2],
        ],
        dim=-1,
    )
    return x * inv_det[..., None]


def parallax_cos(o1, o2, pt3):
    """|cos| of ray angle from camera centers o1,o2 to point pt3 (..., 3)."""
    p1 = pt3 - o1
    p2 = pt3 - o2
    num = torch.abs(torch.sum(p1 * p2, dim=-1))
    den = torch.linalg.norm(p1, dim=-1) * torch.linalg.norm(p2, dim=-1)
    return num / torch.clamp(den, min=1e-12)


def check_parallax(o1, o2, pt3, min_degree: int):
    """True where parallax exceeds min_degree (1..4)
    (reference cvu::checkParallax, src/cvutil.cpp:92)."""
    return parallax_cos(o1, o2, pt3) < _MIN_COS[min_degree - 1]
