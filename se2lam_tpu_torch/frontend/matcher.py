"""ORB descriptor matching as dense tensor ops (port of
se2lam_tpu.frontend.matcher; reference src/ORBmatcher.cpp).

256-bit Hamming distance is a ±1 product, ``dist = (256 − a·bᵀ)/2``; the
f32 product of ±1 (and 0 for invalid slots) is exact with TF32 off.
Window gating, best/second-best ratio tests, mutual exclusion and the
30-bin rotation-consistency histogram are masked batched ops. Constants
TH_LOW=75, TH_HIGH=100, HISTO_LENGTH=30 follow src/ORBmatcher.cpp:45-47.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .orb import OrbFeatures

__all__ = [
    "TH_LOW",
    "TH_HIGH",
    "hamming_matrix",
    "match_by_window",
    "match_by_projection",
    "mutual_match",
]

TH_LOW = 75.0
TH_HIGH = 100.0
HISTO_LENGTH = 30
_BIG = 1e9


def hamming_matrix(pm1_a, pm1_b):
    """(Na, 256) ±1 int8 × (Nb, 256) ±1 int8 → (Na, Nb) f32 Hamming."""
    dot = pm1_a.to(torch.float32) @ pm1_b.to(torch.float32).T
    return (256.0 - dot) * 0.5


def _top2_min(D):
    """Row-wise (best, second, argbest) of a masked distance matrix; the
    lowest column wins a tie, as ``jnp.argmin``."""
    best = D.min(dim=1).values
    idx = torch.argmin(D, dim=1)
    col = torch.arange(D.shape[1], device=D.device)[None, :]
    D2 = torch.where(col == idx[:, None], torch.full_like(D, math.inf), D)
    second = D2.min(dim=1).values
    return best, second, idx


def _mutual_filter(accept, best_idx, best_dist, n_cols: int):
    """Keep only the lowest-distance claimant of each column, lowest row
    first among equals: a two-stage scatter-min (distance, then row id)
    in place of the reference's sequential overwrite bookkeeping
    (src/ORBmatcher.cpp:289-335)."""
    n_rows = accept.shape[0]
    dev = accept.device
    row_ids = torch.arange(n_rows, device=dev)
    d = torch.where(accept, best_dist, torch.full_like(best_dist, math.inf))
    col_min = torch.full((n_cols,), math.inf, device=dev).scatter_reduce(
        0, best_idx, d, reduce="amin", include_self=True
    )
    is_best = accept & (d <= col_min[best_idx])
    r = torch.where(is_best, row_ids, torch.full_like(row_ids, n_rows))
    col_row = torch.full((n_cols,), n_rows, dtype=r.dtype, device=dev).scatter_reduce(
        0, best_idx, r, reduce="amin", include_self=True
    )
    return is_best & (row_ids == col_row[best_idx])


def _rotation_consistency(accept, angle1, angle2_at_best):
    """30-bin rotation histogram; keep matches in the 3 dominant bins
    (src/ORBmatcher.cpp:350-372 + ComputeThreeMaxima semantics: 2nd/3rd
    bins dropped when below 10% of the best bin)."""
    rot = (angle1 - angle2_at_best) * (180.0 / math.pi)
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.remainder(
        torch.round(rot * (HISTO_LENGTH / 360.0)).to(torch.int64), HISTO_LENGTH
    )
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=accept.device)
    hist = hist.index_add(0, bins, accept.to(torch.int32))
    top_counts, order = torch.sort(hist, descending=True, stable=True)
    top_counts, top_bins = top_counts[:3], order[:3]
    keep_bin = (top_counts.to(torch.float32) >= 0.1 * top_counts[0]) & (
        top_counts > 0
    )
    in_top = (bins[:, None] == top_bins[None, :]) & keep_bin[None, :]
    return accept & in_top.any(dim=1)


class WindowMatches(NamedTuple):
    idx2: torch.Tensor   # (N1,) int32 — match into frame 2, -1 if none
    dist: torch.Tensor   # (N1,) f32
    n: torch.Tensor      # () int32


def _level_gate(oct_rows, oct_cols, level_offset: int):
    lo = torch.clamp(oct_rows[:, None] - level_offset, min=0)
    return (oct_cols[None, :] >= lo) & (oct_cols[None, :] <= oct_rows[:, None] + level_offset)


def _window_matches(accept, best_idx, best):
    idx2 = torch.where(accept, best_idx, torch.full_like(best_idx, -1))
    return WindowMatches(
        idx2=idx2.to(torch.int32),
        dist=torch.where(accept, best, torch.full_like(best, math.inf)),
        n=accept.sum(dtype=torch.int32),
    )


def match_by_window(
    f1: OrbFeatures,
    f2: OrbFeatures,
    prev_xy,
    win_size: float = 20.0,
    nn_ratio: float = 0.9,
    level_offset: int = 1,
) -> WindowMatches:
    """Frame-to-frame search in a square pixel window around the previous
    positions (reference MatchByWindow, src/ORBmatcher.cpp:278-381).
    prev_xy: (N1, 2) predicted positions in frame 2 (level-0 px)."""
    D = hamming_matrix(f1.desc_pm1, f2.desc_pm1)
    dx = (f2.xy[None, :, 0] - prev_xy[:, None, 0]).abs()
    dy = (f2.xy[None, :, 1] - prev_xy[:, None, 1]).abs()
    in_win = (dx <= win_size) & (dy <= win_size)
    gate = (in_win & _level_gate(f1.octave, f2.octave, level_offset)
            & f1.valid[:, None] & f2.valid[None, :])

    Dm = torch.where(gate, D, torch.full_like(D, _BIG))
    best, second, best_idx = _top2_min(Dm)
    accept = (best <= TH_LOW) & (best < nn_ratio * second) & f1.valid
    accept = _mutual_filter(accept, best_idx, best, f2.xy.shape[0])
    accept = _rotation_consistency(accept, f1.angle, f2.angle[best_idx])
    return _window_matches(accept, best_idx, best)


def match_by_projection(
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
    """Match projected map points against a keyframe's free features
    (reference MatchByProjection, src/ORBmatcher.cpp:383-454).

    mp_uv (M, 2) predicted pixels, mp_octave (M,), mp_desc_pm1 (M, 256),
    mp_valid (M,) bool, feat_free (N,) bool. Returns ((N,) int32 matched
    map-point index per feature or -1, () int32 count). The window is
    ``max(octave, 1) · win_size``, keeping level-0 points matchable.
    """
    D = hamming_matrix(mp_desc_pm1, feats.desc_pm1)  # (M, N)
    win = torch.clamp(mp_octave.to(torch.float32), min=1.0) * win_size
    dx = (feats.xy[None, :, 0] - mp_uv[:, None, 0]).abs()
    dy = (feats.xy[None, :, 1] - mp_uv[:, None, 1]).abs()
    in_win = (dx <= win[:, None]) & (dy <= win[:, None])
    gate = (
        in_win
        & _level_gate(mp_octave, feats.octave, level_offset)
        & mp_valid[:, None]
        & feats.valid[None, :]
        & feat_free[None, :]
    )
    Dm = torch.where(gate, D, torch.full_like(D, _BIG))
    best, second, best_idx = _top2_min(Dm)
    best_lvl = feats.octave[best_idx]
    # second-best level: recompute with best masked out
    Dm2 = Dm.clone()
    Dm2[torch.arange(Dm.shape[0], device=Dm.device), best_idx] = _BIG
    _, _, second_idx = _top2_min(Dm2)
    second_lvl = feats.octave[second_idx]
    ratio_fail = (best_lvl == second_lvl) & (best > nn_ratio * second)
    accept = (best <= TH_HIGH) & (~ratio_fail) & mp_valid
    accept = _mutual_filter(accept, best_idx, best, feats.xy.shape[0])

    # invert: per feature, which MP matched it (rejected rows land on a
    # dropped extra slot; accepted columns are unique after the filter)
    n_feats = feats.xy.shape[0]
    m_ids = torch.arange(mp_uv.shape[0], dtype=torch.int32, device=Dm.device)
    feat_match = torch.full((n_feats + 1,), -1, dtype=torch.int32, device=Dm.device)
    feat_match[torch.where(accept, best_idx, torch.full_like(best_idx, n_feats))] = (
        torch.where(accept, m_ids, torch.full_like(m_ids, -1))
    )
    return feat_match[:n_feats], accept.sum(dtype=torch.int32)


def mutual_match(
    f1: OrbFeatures,
    f2: OrbFeatures,
    nn_ratio: float = 1.0,
    max_dist: float = TH_LOW,
    check_rotation: bool = True,
) -> WindowMatches:
    """Unconstrained mutual best match over full descriptor sets — the
    batched stand-in for SearchByBoW (src/ORBmatcher.cpp:128-276)."""
    D = hamming_matrix(f1.desc_pm1, f2.desc_pm1)
    gate = f1.valid[:, None] & f2.valid[None, :]
    Dm = torch.where(gate, D, torch.full_like(D, _BIG))
    best, second, best_idx = _top2_min(Dm)
    accept = (best <= max_dist) & (best < nn_ratio * second) & f1.valid
    accept = _mutual_filter(accept, best_idx, best, f2.xy.shape[0])
    if check_rotation:
        accept = _rotation_consistency(accept, f1.angle, f2.angle[best_idx])
    return _window_matches(accept, best_idx, best)
