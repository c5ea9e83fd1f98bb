"""Sums whose order does not depend on a fleet's size.

Under ``torch.vmap`` over robots, a robot's sums on the card would take
another order at every fleet size: the CUDA ``torch.sum`` splits a long
axis by how many sums it computes at once, and cuBLAS picks a batched
product's kernel, and with it the order of its sums, by the batch's size.
``examples/torch_fleet_trace.py`` shows three such sums in a tracking step
(a 1000-point ``torch.sum`` and a (3,)·(3, 3) ``einsum`` in RANSAC, the
3x3 normal equations of DLT triangulation), enough to change a robot's
inliers, and with them its keyframe decisions, with the fleet it runs in.
The fleet localizer's step has more: the pose-only solve's cost and
normal equations (sums over the frame's features), its 3x3 step, and the
small products of the SE(3) transforms and the reprojection Jacobians
(``ops/se3``, ``factors``, ``mapstate.kf_Tcw``).

On a CUDA tensor that a ``torch.func`` transform wraps, these helpers use
forms whose order is fixed by the shapes of one robot's problem: products
summed over a short last axis, and long sums halved with elementwise adds.
Elsewhere they are the plain forms: an unbatched call has no fleet to
depend on and keeps its bits, and on the CPU the plain forms keep one
order at any batch size and give the bits that the parity tests hold
against the JAX package. The one exception is ``forced()``: within it a
CUDA tensor takes the fixed forms batched or not, which the localizer's
tracked step uses so that a robot localized alone on the card is bitwise
the same robot in a fleet.

The solvers' scatter-adds of floats (local BA's and the joint GBA's
observation and odometry terms, the pose graph's right-hand side, the
mesh's point blocks and pose-graph edges) go through ``index_add`` and
``index_add_``. The CUDA ``index_add_`` adds with atomics, in another order
every run, so a solve on the card moved from run to run. On a CUDA tensor
these helpers sum each index's values in their input order instead
(``segment_sum``: the values gathered in a stable sort of the indices,
then ``torch.segment_reduce``, which adds each segment's values one after
the other), so a solve gives the same bits every run. The sort is made
once for an index tensor and kept with it (``_segments``): the LM steps of
a solve pass the same observation and edge indices, and sort them once.
On the CPU the helpers are ``index_add_``, which adds in input order and
keeps the bits that the parity tests hold against the JAX package.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["forced", "active", "batched", "sum_halving", "sum_points", "matmul", "contract",
           "rows_matvec", "rows_vecmat", "segment_sum", "index_add", "index_add_"]


_FORCED = threading.local()


@contextlib.contextmanager
def forced(on: bool = True):
    """Within it (this thread only), CUDA tensors take the fixed-order
    forms whether a transform wraps them or not."""
    prev = getattr(_FORCED, "on", False)
    _FORCED.on = on
    try:
        yield
    finally:
        _FORCED.on = prev


def _fixed(*xs) -> bool:
    force = getattr(_FORCED, "on", False)
    return any(x.device.type == "cuda"
               and (force or torch._C._functorch.is_functorch_wrapped_tensor(x)) for x in xs)


def active(*xs) -> bool:
    """Whether the fixed-order forms apply to these tensors."""
    return _fixed(*xs)


def batched(*xs) -> bool:
    """Whether any of these tensors is a ``torch.func`` transform's, on any
    device (the pose-only solve's sums depend on the batch's size on the
    CPU too)."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(x) for x in xs)


def sum_halving(x):
    """Sum over the last axis in a fixed order (``_sum_halving``)."""
    return _sum_halving(x)


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


# index tensor -> ((its version, n), stable-sort permutation, segment offsets)
_SEGMENTS = WeakIdKeyDictionary()


def _segments(idx, n: int):
    """(perm, offsets): ``idx[perm]`` sorted stably, and the (n + 1,)
    offsets of each value's segment in it. Kept with ``idx`` while it
    lives and is not written to."""
    hit = _SEGMENTS.get(idx)
    if hit is not None and hit[0] == (idx._version, n):
        return hit[1], hit[2]
    srt, perm = torch.sort(idx.long(), stable=True)
    offsets = torch.searchsorted(srt, torch.arange(n + 1, device=idx.device))
    _SEGMENTS[idx] = ((idx._version, n), perm, offsets)
    return perm, offsets


def segment_sum(idx, vals, n: int):
    """(n, ...) sums of ``vals`` (len(idx), ...) by their index in
    [0, n), each index's values added in their input order."""
    perm, offsets = _segments(idx, n)
    return torch.segment_reduce(vals.index_select(0, perm), "sum", offsets=offsets, axis=0,
                                unsafe=True)


def index_add_(x, idx, vals):
    """``x.index_add_(0, idx, vals)``; on the card in the order of
    ``segment_sum``."""
    if x.is_cuda:
        return x.add_(segment_sum(idx, vals, x.shape[0]))
    return x.index_add_(0, idx, vals)


def index_add(x, idx, vals):
    """``x.index_add(0, idx, vals)``; on the card in the order of
    ``segment_sum``."""
    if x.is_cuda:
        return x + segment_sum(idx, vals, x.shape[0])
    return x.index_add(0, idx, vals)
