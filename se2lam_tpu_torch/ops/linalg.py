"""Closed-form small-matrix linear algebra (port of the parts of
se2lam_tpu.ops.linalg that the port uses): unrolled Gauss–Jordan for small
PD matrices and adjugate 2x2/3x3 inverses, with the reference's
elimination order and pivot floors, and the block-tridiagonal factor and
solve of the distributed solvers' chain-aware preconditioner.
"""
from __future__ import annotations

import torch

__all__ = ["inv2x2", "inv3x3", "inv_psd_small", "block_tridiag_factor", "block_tridiag_solve"]


def inv_psd_small(M, eps: float = 1e-30):
    """Batched inverse of small (…, n, n) positive-definite matrices via
    unrolled Gauss–Jordan without pivoting.

    For PD matrices the running pivots are the (positive) Schur-complement
    diagonals, so pivot-free elimination is stable. Step k scales row k by
    its pivot, then subtracts ``col[i] * row_k`` from every other row i —
    the same order as the JAX version.
    """
    n = M.shape[-1]
    A = M.clone()
    # made from M, so that under a vmap over M it is batched and takes the
    # batched row writes below
    I = torch.zeros_like(M) + torch.eye(n, dtype=M.dtype, device=M.device)
    not_k = ~torch.eye(n, dtype=torch.bool, device=M.device)
    for k in range(n):
        piv = A[..., k, k]
        piv = torch.where(piv.abs() < eps, torch.full_like(piv, eps), piv)
        inv_piv = (1.0 / piv)[..., None]
        row_a = A[..., k, :] * inv_piv
        row_i = I[..., k, :] * inv_piv
        A[..., k, :] = row_a
        I[..., k, :] = row_i
        col = A[..., :, k]
        factor = torch.where(not_k[k], col, torch.zeros_like(col))[..., :, None]
        A = A - factor * row_a[..., None, :]
        I = I - factor * row_i[..., None, :]
    return I


def inv2x2(M, eps: float = 1e-30):
    """Batched (…, 2, 2) inverse via the adjugate."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def inv3x3(M, eps: float = 1e-30):
    """Batched (…, 3, 3) inverse via the adjugate (cofactor) formula."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m02 * m21 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c10 = m12 * m20 - m10 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m02 * m10 - m00 * m12
    c20 = m10 * m21 - m11 * m20
    c21 = m01 * m20 - m00 * m21
    c22 = m00 * m11 - m01 * m10
    det = m00 * c00 + m01 * c10 + m02 * c20
    inv_det = 1.0 / torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def block_tridiag_factor(D, L, eps: float = 1e-9):
    """Forward factorization of a symmetric block-tridiagonal system with
    (K, b, b) diagonal blocks ``D`` and sub-diagonal blocks ``L`` (``L[k]``
    couples row k to row k-1; ``L[0]`` must be zero). Returns (Cinv, L),
    ``Cinv[k]`` the inverse of the running Schur complement
    C_k = D_k − L_k C_{k-1}⁻¹ L_kᵀ: a K-step sequential sweep of b×b
    solves, in the JAX package's order (``se2lam_tpu/ops/linalg.py:47``).

    The odometry chain of a SLAM pose graph is exactly block-tridiagonal;
    solving it directly removes the O(K) CG-iteration wall that a
    block-Jacobi preconditioner hits on chain-dominated graphs."""
    b = D.shape[-1]
    eye = torch.eye(b, dtype=D.dtype, device=D.device)
    inv = inv3x3 if b == 3 else inv_psd_small
    prev = torch.zeros((b, b), dtype=D.dtype, device=D.device)
    out = []
    for k in range(D.shape[0]):
        Lk = L[k]
        prev = inv(D[k] - Lk @ prev @ Lk.transpose(-1, -2) + eps * eye)
        out.append(prev)
    return torch.stack(out), L


def _affine_scan(A, c):
    """z_k = A_k z_{k-1} + c_k from z_{-1} = 0, for every k at once: a
    Hillis-Steele scan over the affine maps (A_k, c_k), log2(K) levels of
    batched 3x3 products instead of K sequential steps."""
    K, s = c.shape[0], 1
    while s < K:
        c = torch.cat([c[:s], c[s:] + (A[s:] @ c[:-s, :, None])[..., 0]])
        A = torch.cat([A[:s], A[s:] @ A[:-s]])
        s *= 2
    return c


def block_tridiag_solve(Cinv, L, r):
    """Solve M x = r with ``block_tridiag_factor``'s factorization: the
    forward sweep y_k = C_k⁻¹ (r_k − L_k y_{k-1}), then the backward sweep
    x_k = y_k − C_k⁻¹ L_{k+1}ᵀ x_{k+1}. ``r`` is (K, b); returns (K, b).

    Both sweeps are linear recurrences, solved as parallel scans
    (``_affine_scan``): the sums group differently from the JAX package's
    sequential ``lax.scan``, which an f32 tolerance covers."""
    y = _affine_scan(-Cinv @ L, (Cinv @ r[..., None])[..., 0])
    Lnext = torch.cat([L[1:], torch.zeros_like(L[:1])])
    B = -Cinv @ Lnext.transpose(-1, -2)
    return _affine_scan(B.flip(0), y.flip(0)).flip(0)
