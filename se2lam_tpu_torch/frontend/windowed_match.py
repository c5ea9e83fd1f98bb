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

``windowed_top2.launches`` counts kernel launches (CUDA calls only).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import load_library
from .matcher import TH_HIGH, _mutual_filter, hamming_matrix
from .orb import OrbFeatures

__all__ = [
    "windowed_top2", "windowed_top2_plain", "windowed_gate", "projection_match_inputs",
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
    Dm.scatter_(1, arg[:, None], _BIG)
    second, arg2 = Dm.min(dim=1).values, torch.argmin(Dm, dim=1)
    return best, second, arg.to(torch.int32), arg2.to(torch.int32)


def _kernel_fn():
    lib = load_library("windowed_top2")
    fn = lib.se2lam_windowed_top2
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] + [
            ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
    return fn


def windowed_top2(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1,
                  d2_pm1, xy2, oct2, valid2):
    """Rows: d1_pm1 (N1, 256) ±1 int8, xy_pred (N1, 2), win, lvl_lo, lvl_hi
    (N1,) f32, valid1 (N1,) bool. Columns: d2_pm1 (N2, 256) int8, xy2
    (N2, 2) f32, oct2 (N2,) int32, valid2 (N2,) bool. Returns (best,
    second) (N1,) f32 and (argbest, argsecond) (N1,) int32."""
    args = (d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2)
    dev = d1_pm1.device
    if dev.type == "cpu":
        return windowed_top2_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"windowed_top2: unsupported device {dev}")
    N1, N2 = d1_pm1.shape[0], d2_pm1.shape[0]
    want = (
        (torch.int8, (N1, 256)), (torch.float32, (N1, 2)), (torch.float32, (N1,)),
        (torch.float32, (N1,)), (torch.float32, (N1,)), (torch.bool, (N1,)),
        (torch.int8, (N2, 256)), (torch.float32, (N2, 2)), (torch.int32, (N2,)),
        (torch.bool, (N2,)),
    )
    ok = all(
        a.dtype == dt and tuple(a.shape) == sh and a.is_contiguous() and a.device == dev
        for a, (dt, sh) in zip(args, want)
    ) and d1_pm1.data_ptr() % 16 == 0 and d2_pm1.data_ptr() % 16 == 0
    if not ok:
        got = ", ".join(f"{a.dtype} {tuple(a.shape)} contiguous={a.is_contiguous()} on {a.device}"
                        for a in args)
        raise ValueError(
            "windowed_top2: the kernel takes contiguous int8 (N1,256), f32 (N1,2), "
            "3 x f32 (N1,), bool (N1,), int8 (N2,256), f32 (N2,2), int32 (N2,), "
            f"bool (N2,) on one card, descriptors 16-byte aligned; got {got}")
    fn = _kernel_fn()
    best = torch.empty(N1, dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    arg = torch.empty(N1, dtype=torch.int32, device=dev)
    arg2 = torch.empty_like(arg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() for a in args), N1, N2, best.data_ptr(), second.data_ptr(),
                 arg.data_ptr(), arg2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"windowed_top2: kernel launch failed, cudaError {err}")
    windowed_top2.launches += 1
    return best, second, arg, arg2


windowed_top2.launches = 0


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
    m_ids = torch.arange(M, dtype=torch.int32, device=dev)
    feat_match = torch.full((n_feats + 1,), -1, dtype=torch.int32, device=dev)
    feat_match[torch.where(accept, best_idx, torch.full_like(best_idx, n_feats))] = (
        torch.where(accept, m_ids, torch.full_like(m_ids, -1)))
    return feat_match[:n_feats], accept.sum(dtype=torch.int32)
