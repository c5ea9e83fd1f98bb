"""Batched fundamental-matrix RANSAC (port of se2lam_tpu.frontend.ransac;
the cv::findFundamentalMat gates of src/Track.cpp:308-344).

All trials run at once: (T, 8) samples → T normalized 8-point solves
(inverse iteration on 9x9 normal matrices) → T×N Sampson tests → argmax.
Fixed trial count and shapes, no host syncs. Its sums go through
``ops.fixed_order``, so that under a fleet's ``torch.vmap`` on the card a
robot's inliers do not depend on the fleet's size.

The samples are the top 8 of masked Gumbel noise per trial. Torch cannot
reproduce JAX's PRNG stream, so the caller passes either a
``torch.Generator`` (the noise is drawn here) or the drawn noise itself
(``gumbel``, shape (T, N)); the parity tests pass JAX's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.fixed_order import contract, matmul, rows_matvec, rows_vecmat, sum_points
from ..ops.linalg import inv_psd_small

__all__ = ["FundamentalResult", "ransac_fundamental", "draw_gumbel", "skip_gumbel"]


class FundamentalResult(NamedTuple):
    F: torch.Tensor          # (3, 3) best model
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _normalize(pts, valid):
    """Hartley normalization over valid points: centroid 0, RMS √2."""
    w = valid.to(pts.dtype)
    n = torch.clamp(w.sum(), min=1.0)        # a count: exact in any order
    mean = sum_points(pts * w[:, None], 0) / n
    d = torch.linalg.norm(pts - mean, dim=-1)
    rms = torch.clamp(sum_points(d * w) / n, min=1e-9)
    # a true division: ``float / tensor`` would multiply by the reciprocal
    scale = torch.full_like(rms, math.sqrt(2.0)) / rms
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * scale, T


def _min_eigvec(M, iters: int = 3):
    """Smallest eigenvector of symmetric PSD matrices (..., n, n) by inverse
    iteration v ← (M + εI)⁻¹ v, renormalized, with the shift ε scaled to
    the matrix magnitude; the same start vector, shift and counts as the
    JAX version."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    scale = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    Minv = inv_psd_small(M + 1e-9 * scale * eye + 1e-30 * eye)
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    v[..., 0] += 0.5
    for _ in range(iters):
        v = contract("...ij,...j->...i", Minv, v, rows_matvec)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _eight_point(p1, p2):
    """(T, 8, 2), (T, 8, 2) normalized correspondences → (T, 3, 3) F with
    rank 2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1
    )  # (T, 8, 9)
    AtA = matmul(A.transpose(-1, -2), A)
    F = _min_eigvec(AtA).reshape(-1, 3, 3)
    # rank-2 projection: F ← F − u3 (u3ᵀ F v3) v3ᵀ with v3/u3 the smallest
    # right/left singular directions
    v3 = _min_eigvec(matmul(F.transpose(-1, -2), F), iters=20)
    u3_raw = contract("tij,tj->ti", F, v3, rows_matvec)
    u3 = u3_raw / torch.clamp(torch.linalg.norm(u3_raw, dim=-1, keepdim=True), min=1e-12)
    s3 = (contract("ti,tij->tj", u3, F, rows_vecmat) * v3).sum(-1)   # (u3ᵀF)·v3
    return F - s3[:, None, None] * (u3[:, :, None] * v3[:, None, :])


def _sampson(F, p1, p2):
    """(T, N) Sampson distance² of correspondences p1, p2 (N, 2) under each
    of the (T, 3, 3) models."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    Fx1 = matmul(x1, F.transpose(-1, -2))    # (T, N, 3) = F·x1
    Ftx2 = matmul(x2, F)                     # (T, N, 3) = Fᵀ·x2
    num = (x2 * Fx1).sum(dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    # a (near-)zero F makes 0/0: such a hypothesis rejects every point
    return torch.where(
        den > 1e-12, num / torch.clamp(den, min=1e-12), torch.full_like(num, math.inf)
    )


def _exponential(generator: torch.Generator, shape, dtype):
    e = torch.empty(shape, dtype=dtype, device=generator.device)
    return e.exponential_(generator=generator)


def draw_gumbel(generator: torch.Generator, shape, dtype=torch.float32):
    """Standard Gumbel noise −log(E), E ~ Exp(1), drawn from ``generator``
    on its device."""
    return -torch.log(_exponential(generator, shape, dtype))


def skip_gumbel(generator: torch.Generator, shape, dtype=torch.float32):
    """Advance ``generator`` past one ``draw_gumbel`` of ``shape``: the
    same exponential draw (one launch), not transformed; later draws are
    then those that follow the skipped one."""
    _exponential(generator, shape, dtype)


def ransac_fundamental(
    pts1,
    pts2,
    valid,
    n_trials: int = 256,
    thresh_px: float = 3.0,
    min_inliers: int = 10,
    *,
    generator: torch.Generator | None = None,
    gumbel=None,
) -> FundamentalResult:
    """RANSAC fundamental matrix with the reference's discard-all rule:
    fewer than ``min_inliers`` survivors → everything outlier
    (src/Track.cpp:336-341). Exactly one of ``generator`` and ``gumbel``
    ((n_trials, N) noise) must be given."""
    if (generator is None) == (gumbel is None):
        raise ValueError("ransac_fundamental: pass exactly one of generator, gumbel")
    N = pts1.shape[0]
    n1, T1 = _normalize(pts1, valid)
    n2, T2 = _normalize(pts2, valid)

    # 8 valid indices per trial: masked Gumbel top-k, lower index first
    # among equals as lax.top_k (a stable descending sort)
    g = draw_gumbel(generator, (n_trials, N), pts1.dtype) if gumbel is None else gumbel
    if g.shape != (n_trials, N):
        raise ValueError(f"ransac_fundamental: gumbel shape {tuple(g.shape)}, "
                         f"want {(n_trials, N)}")
    g = torch.where(valid[None, :], g, torch.full_like(g, -math.inf))
    sample_idx = torch.sort(g, dim=1, descending=True, stable=True).indices[:, :8]

    Fs = _eight_point(n1[sample_idx], n2[sample_idx])   # (T, 3, 3)

    # score in normalized coords; threshold scaled by the mean of the two
    # normalizations' scales
    scale = 0.5 * (T1[0, 0] + T2[0, 0])
    th2 = (thresh_px * scale) ** 2
    inl = (_sampson(Fs, n1, n2) < th2) & valid[None, :]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)   # first maximum, as jnp.argmax

    F_best = T2.T @ Fs[best] @ T1   # denormalize
    n_in = counts[best]
    enough = n_in >= min_inliers
    return FundamentalResult(
        F=F_best,
        inliers=inl[best] & enough,
        n_inliers=torch.where(enough, n_in, torch.zeros_like(n_in)).to(torch.int32),
    )
