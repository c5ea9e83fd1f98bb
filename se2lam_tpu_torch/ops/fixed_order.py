"""Sums whose order does not depend on a fleet's size.

Under ``torch.vmap`` over robots, a robot's sums on the card would take
another order at every fleet size: the CUDA ``torch.sum`` splits a long
axis by how many sums it computes at once, and cuBLAS picks a batched
product's kernel, and with it the order of its sums, by the batch's size.
``examples/torch_fleet_trace.py`` shows three such sums in a tracking step
(a 1000-point ``torch.sum`` and a (3,)·(3, 3) ``einsum`` in RANSAC, the
3x3 normal equations of DLT triangulation), enough to change a robot's
inliers, and with them its keyframe decisions, with the fleet it runs in.

On a CUDA tensor that a ``torch.func`` transform wraps, these helpers use
forms whose order is fixed by the shapes of one robot's problem: products
summed over a short last axis, and long sums halved with elementwise adds.
Elsewhere they are the plain forms: an unbatched call has no fleet to
depend on and keeps its bits, and on the CPU the plain forms keep one
order at any batch size and give the bits that the parity tests hold
against the JAX package.
"""
from __future__ import annotations

import torch

__all__ = ["sum_points", "matmul", "contract", "rows_matvec", "rows_vecmat"]


def _fixed(*xs) -> bool:
    return any(x.device.type == "cuda" and torch._C._functorch.is_functorch_wrapped_tensor(x)
               for x in xs)


def _sum_halving(x):
    """Sum over the last axis: zero-padded to a power of two, then halved
    with elementwise adds."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _matmul_rows(a, b):
    return (a[..., :, None, :] * b.transpose(-1, -2)[..., None, :, :]).sum(-1)


def rows_matvec(M, v):
    """M (..., m, k) · v (..., k) as products summed over the last axis."""
    return (M * v[..., None, :]).sum(-1)


def rows_vecmat(u, M):
    """uᵀ (..., k) · M (..., k, n) as products summed over the last axis."""
    return (M.transpose(-1, -2) * u[..., None, :]).sum(-1)


def sum_points(x, dim: int | None = None):
    """``x.sum(dim)`` (``x.sum()`` for None) for a long axis (a frame's
    points)."""
    if not _fixed(x):
        return x.sum() if dim is None else x.sum(dim)
    return _sum_halving(x.reshape(-1) if dim is None else x.movedim(dim, -1))


def matmul(a, b):
    """``a @ b``, a (..., m, k) and b (..., k, n) with a short k."""
    if not _fixed(a, b):
        return a @ b
    return _matmul_rows(a, b)


def contract(eq: str, a, b, rows):
    """``torch.einsum(eq, a, b)``, or ``rows(a, b)``, the same contraction
    as products summed over a short last axis (``rows_matvec``,
    ``rows_vecmat``), where the order has to be fixed."""
    if not _fixed(a, b):
        return torch.einsum(eq, a, b)
    return rows(a, b)
