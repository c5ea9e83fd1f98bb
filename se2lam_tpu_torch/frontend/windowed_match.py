"""Gated best/second Hamming match without the N1×N2 matrix, dispatched by
device (port of se2lam_tpu/frontend/pallas_match.py).

``windowed_top2`` gives, for every row-1 descriptor against all row-2
descriptors under a per-row window, octave and validity gate, the best
and second distances and their columns. A CPU tensor runs the plain
version (the dense two-pass min/argmin); a CUDA tensor launches the
hand-written kernel ``csrc/windowed_top2.cu`` or raises. There is no
fallback from the card to the plain version, and no size routing.

Ties: ``argbest`` is the lowest column at the minimum, ``second`` the
minimum over the other columns, ``argsecond`` the lowest column reaching
it; a row with no candidate gives (1e9, 1e9, 0, 0), and a row with one
candidate (d, 1e9, c, 0). The kernel equals the plain version on all
four outputs. (The Pallas kernel may return another column on a tied
distance, ``tests/test_pallas_match.py``.)

``match_by_projection_streamed`` is the port's one MatchByProjection, on
top of it: the Localizer's projection match and keyframe insertion's
(``localmap.add_keyframe``) both run it.

``windowed_top2_batched`` serves B robots matching against one shared bank
of rows in one launch (a fleet localizing on one map): rows' descriptors,
windows and octave gates shared, projected positions and row validity
(B, N1) and columns (B, N2, ...) per robot. Both are also ``torch.library``
custom ops (``se2lam::windowed_top2``, ``se2lam::windowed_top2_batched``)
with fake implementations, and ``torch.func.vmap`` over ``windowed_top2``
with shared rows makes the one batched launch, never a loop over robots.
The op's dispatch costs tens of µs a call, so the wrappers take it only
under a ``torch.func`` transform; plain tensors launch directly.

``windowed_top2.launches`` counts kernel launches (CUDA calls only), one
per launch whatever B.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import load_library
from .matcher import TH_HIGH, _mutual_filter, hamming_matrix
from .orb import OrbFeatures

__all__ = [
    "windowed_top2", "windowed_top2_plain", "windowed_top2_batched",
    "windowed_top2_batched_plain", "windowed_gate", "projection_match_inputs",
    "match_by_projection_streamed",
]

_BIG = 1e9


def windowed_gate(xy_pred, win, lvl_lo, lvl_hi, valid1, xy2, oct2, valid2):
    """(N1, N2) bool: |Δx| ≤ win, |Δy| ≤ win, lo ≤ oct2 ≤ hi, both valid,
    in f32 as the Pallas kernel computes it (``pallas_match.py:77-85``)."""
    o2 = oct2.to(torch.float32)[None, :]
    return (
        ((xy2[None, :, 0] - xy_pred[:, None, 0]).abs() <= win[:, None])
        & ((xy2[None, :, 1] - xy_pred[:, None, 1]).abs() <= win[:, None])
        & (o2 >= lvl_lo[:, None]) & (o2 <= lvl_hi[:, None])
        & valid1[:, None] & valid2[None, :]
    )


def windowed_top2_plain(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1,
                        d2_pm1, xy2, oct2, valid2):
    """The plain torch version of the kernel: the dense gated distance
    matrix, min/argmin, the best column masked to 1e9, min/argmin again."""
    D = hamming_matrix(d1_pm1, d2_pm1)
    gate = windowed_gate(xy_pred, win, lvl_lo, lvl_hi, valid1, xy2, oct2, valid2)
    Dm = torch.where(gate, D, torch.full_like(D, _BIG))
    best, arg = Dm.min(dim=1).values, torch.argmin(Dm, dim=1)
    cols = torch.arange(Dm.shape[1], device=Dm.device)
    Dm = torch.where(cols[None, :] == arg[:, None], torch.full_like(Dm, _BIG), Dm)
    second, arg2 = Dm.min(dim=1).values, torch.argmin(Dm, dim=1)
    return best, second, arg.to(torch.int32), arg2.to(torch.int32)


# row arguments (d1_pm1, win, lvl_lo, lvl_hi) are shared by every robot
_ROW_ARGS = (0, 2, 3, 4)
_ROBOT_DIMS = (None, 0, None, None, None, 0, 0, 0, 0, 0)


def windowed_top2_batched_plain(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1,
                                d2_pm1, xy2, oct2, valid2):
    """The batched plain version: ``windowed_top2_plain`` over the robots'
    leading axis, with the rows shared."""
    return torch.vmap(windowed_top2_plain, in_dims=_ROBOT_DIMS)(
        d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2)


def _kernel_fn():
    lib = load_library("windowed_top2")
    fn = lib.se2lam_windowed_top2_batched
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def _launch(B, args):
    """One kernel launch for B robots (B = None: the unbatched shapes)."""
    dev = args[0].device
    N1, N2 = args[0].shape[0], args[6].shape[-2]
    lead = () if B is None else (B,)
    want = (
        (torch.int8, (N1, 256)), (torch.float32, lead + (N1, 2)), (torch.float32, (N1,)),
        (torch.float32, (N1,)), (torch.float32, (N1,)), (torch.bool, lead + (N1,)),
        (torch.int8, lead + (N2, 256)), (torch.float32, lead + (N2, 2)),
        (torch.int32, lead + (N2,)), (torch.bool, lead + (N2,)),
    )
    ok = all(
        a.dtype == dt and tuple(a.shape) == sh and a.is_contiguous() and a.device == dev
        for a, (dt, sh) in zip(args, want)
    ) and args[0].data_ptr() % 16 == 0 and args[6].data_ptr() % 16 == 0
    if not ok:
        got = ", ".join(f"{a.dtype} {tuple(a.shape)} contiguous={a.is_contiguous()} on {a.device}"
                        for a in args)
        raise ValueError(
            "windowed_top2: the kernel takes contiguous int8 (N1,256), f32 [B,](N1,2), "
            "3 x f32 (N1,), bool [B,](N1,), int8 [B,](N2,256), f32 [B,](N2,2), int32 [B,](N2,), "
            f"bool [B,](N2,) on one card, descriptors 16-byte aligned; got {got}")
    fn = _kernel_fn()
    best = torch.empty(lead + (N1,), dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    arg = torch.empty(lead + (N1,), dtype=torch.int32, device=dev)
    arg2 = torch.empty_like(arg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(1 if B is None else B, *(a.data_ptr() for a in args), N1, N2,
                 best.data_ptr(), second.data_ptr(), arg.data_ptr(), arg2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"windowed_top2: kernel launch failed, cudaError {err}")
    windowed_top2.launches += 1
    return best, second, arg, arg2


def _on_device(args, plain, launch):
    dev = args[0].device
    if dev.type == "cpu":
        return plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"windowed_top2: unsupported device {dev}")
    return launch(args)


_Top2 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@torch.library.custom_op("se2lam::windowed_top2", mutates_args=())
def _top2_op(d1_pm1: torch.Tensor, xy_pred: torch.Tensor, win: torch.Tensor,
             lvl_lo: torch.Tensor, lvl_hi: torch.Tensor, valid1: torch.Tensor,
             d2_pm1: torch.Tensor, xy2: torch.Tensor, oct2: torch.Tensor,
             valid2: torch.Tensor) -> _Top2:
    args = (d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2)
    return _on_device(args, windowed_top2_plain, lambda a: _launch(None, a))


@torch.library.custom_op("se2lam::windowed_top2_batched", mutates_args=())
def _top2_batched_op(d1_pm1: torch.Tensor, xy_pred: torch.Tensor, win: torch.Tensor,
                     lvl_lo: torch.Tensor, lvl_hi: torch.Tensor, valid1: torch.Tensor,
                     d2_pm1: torch.Tensor, xy2: torch.Tensor, oct2: torch.Tensor,
                     valid2: torch.Tensor) -> _Top2:
    args = (d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2)
    return _on_device(args, windowed_top2_batched_plain,
                      lambda a: _launch(xy_pred.shape[0], a))


def _fake_outputs(lead, N1, like):
    f = like.new_empty(lead + (N1,), dtype=torch.float32)
    i = like.new_empty(lead + (N1,), dtype=torch.int32)
    return f, torch.empty_like(f), i, torch.empty_like(i)


@_top2_op.register_fake
def _(d1_pm1, xy_pred, *rest):
    return _fake_outputs((), d1_pm1.shape[0], xy_pred)


@_top2_batched_op.register_fake
def _(d1_pm1, xy_pred, *rest):
    return _fake_outputs((xy_pred.shape[0],), d1_pm1.shape[0], xy_pred)


@_top2_op.register_vmap
def _(info, in_dims, *args):
    """vmap over robots: the shared rows stay as they are, every per-robot
    argument gets its robot axis first, and one batched launch serves all."""
    if any(in_dims[i] is not None for i in _ROW_ARGS):
        raise NotImplementedError(
            "windowed_top2 under vmap: the rows (d1_pm1, win, lvl_lo, lvl_hi) are shared by "
            "every robot and take no batch axis")
    B = info.batch_size
    batched = [
        a if i in _ROW_ARGS else (
            a.movedim(d, 0) if d is not None else a.expand((B,) + tuple(a.shape))).contiguous()
        for i, (a, d) in enumerate(zip(args, in_dims))
    ]
    return _top2_batched_op(*batched), (0, 0, 0, 0)


def _under_transform(args):
    """Whether an argument is a ``torch.func`` transform's wrapper (a
    ``vmap``'s batched tensor): only those need the custom op's dispatch."""
    return any(torch._C._functorch.is_functorch_wrapped_tensor(a) for a in args)


def windowed_top2(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1,
                  d2_pm1, xy2, oct2, valid2):
    """Rows: d1_pm1 (N1, 256) ±1 int8, xy_pred (N1, 2), win, lvl_lo, lvl_hi
    (N1,) f32, valid1 (N1,) bool. Columns: d2_pm1 (N2, 256) int8, xy2
    (N2, 2) f32, oct2 (N2,) int32, valid2 (N2,) bool. Returns (best,
    second) (N1,) f32 and (argbest, argsecond) (N1,) int32. Plain tensors
    go straight to the launch (or the plain version on the CPU); under
    ``torch.vmap`` the custom op's vmap rule makes one batched launch."""
    args = (d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2)
    if _under_transform(args):
        return _top2_op(*args)
    return _on_device(args, windowed_top2_plain, lambda a: _launch(None, a))


windowed_top2.launches = 0


def windowed_top2_batched(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1,
                          d2_pm1, xy2, oct2, valid2):
    """B robots against shared rows in one launch: d1_pm1 (N1, 256), win,
    lvl_lo, lvl_hi (N1,) shared; xy_pred (B, N1, 2), valid1 (B, N1) and
    the columns d2_pm1 (B, N2, 256), xy2 (B, N2, 2), oct2 (B, N2), valid2
    (B, N2) per robot. Returns ``windowed_top2``'s outputs with a leading
    B; robot b's are bitwise those of ``windowed_top2`` on its inputs."""
    args = (d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2)
    if _under_transform(args):
        return _top2_batched_op(*args)
    return _on_device(args, windowed_top2_batched_plain, lambda a: _launch(xy_pred.shape[0], a))


def projection_match_inputs(feats: OrbFeatures, mp_uv, mp_octave, mp_desc_pm1, mp_valid,
                            feat_free, win_size: float = 15.0, level_offset: int = 1):
    """``windowed_top2``'s arguments for a projection match: map points as
    rows, with the window ``max(octave, 1)·win_size`` and the octave gate
    [octave − level_offset (≥ 0), octave + level_offset]; the free valid
    features as columns."""
    win = torch.clamp(mp_octave.to(torch.float32), min=1.0) * win_size
    lo = torch.clamp(mp_octave - level_offset, min=0).to(torch.float32)
    hi = (mp_octave + level_offset).to(torch.float32)
    return (mp_desc_pm1, mp_uv, win, lo, hi, mp_valid,
            feats.desc_pm1, feats.xy, feats.octave, feats.valid & feat_free)


def match_by_projection_streamed(
    feats: OrbFeatures,
    mp_uv,
    mp_octave,
    mp_desc_pm1,
    mp_valid,
    feat_free,
    win_size: float = 15.0,
    nn_ratio: float = 0.9,
    level_offset: int = 1,
):
    """MatchByProjection (src/ORBmatcher.cpp:383-454) with the gated
    distance pass in ``windowed_top2``: the TH_HIGH gate, the same-level
    ratio test through the second-best column, the mutual filter and the
    per-feature inversion. Rows: mp_uv (M, 2) predicted pixels, mp_octave
    (M,), mp_desc_pm1 (M, 256), mp_valid (M,) bool; columns: the features
    with feat_free (N,) bool. Returns ((N,) int32 matched map-point index
    per feature or −1, () int32 count)."""
    M, n_feats = mp_uv.shape[0], feats.xy.shape[0]
    dev = mp_uv.device
    best, second, best_idx, second_idx = windowed_top2(*projection_match_inputs(
        feats, mp_uv, mp_octave, mp_desc_pm1, mp_valid, feat_free, win_size, level_offset))
    best_idx = best_idx.long()
    best_lvl = feats.octave[best_idx]
    second_lvl = feats.octave[second_idx.long()]
    ratio_fail = (second < _BIG) & (best_lvl == second_lvl) & (best > nn_ratio * second)
    accept = (best <= TH_HIGH) & ~ratio_fail & mp_valid
    accept = _mutual_filter(accept, best_idx, best, n_feats)

    # rejected rows land on a spare slot that is cut off; accepted columns
    # are unique after the mutual filter
    # (out of place, so that a vmap over robots can write batched values)
    m_ids = torch.arange(M, dtype=torch.int32, device=dev)
    feat_match = torch.full((n_feats + 1,), -1, dtype=torch.int32, device=dev).index_put(
        (torch.where(accept, best_idx, torch.full_like(best_idx, n_feats)),),
        torch.where(accept, m_ids, torch.full_like(m_ids, -1)))
    return feat_match[:n_feats], accept.sum(dtype=torch.int32)
