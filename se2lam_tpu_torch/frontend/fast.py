"""Dense FAST-9/16 corner scores and 3x3 NMS as plain torch ops (port of
se2lam_tpu.frontend.fast).

This is the plain version of the FAST+NMS kernel (``fast_nms.py`` and
``csrc/fast_nms.cu``): the CPU path runs it, and the kernel is held
bitwise equal to it over the whole map. Two rules make that possible:

- reads wrap on both axes, as ``roll`` does; NMS treats neighbours
  outside the image as −∞ (SAME-padded max);
- the 16 margins are summed one by one in ``_CIRCLE`` order, the bright
  and the dark side separately, then maxed. Only subtractions, max and
  adds appear, so no fused multiply-add can change a bit.

The contiguous-arc test uses log-doubling over the circular axis:
``a_k[i] = AND of flags[i..i+k-1]`` built as a2 = f&rot1(f),
a4 = a2&rot2(a2), a8 = a4&rot4(a4), a9 = a8&rot8(f).
"""
from __future__ import annotations

import torch

__all__ = ["fast_score", "fast_score_pair", "nms3x3"]

# Bresenham circle of radius 3, in circular order: (dx, dy)
_CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _circle_diffs(img):
    """(16, H, W) intensity differences along the Bresenham circle."""
    shifted = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(0, 1)) for dx, dy in _CIRCLE]
    )  # shifted[i][y,x] = img[y+dy, x+dx]
    return shifted - img[None]


def _arc_test(signed_diff, threshold):
    """(H, W) bool: some run of ≥9 contiguous circle pixels clears the
    threshold on this polarity."""
    flags = signed_diff > threshold
    a2 = flags & torch.roll(flags, -1, dims=0)
    a4 = a2 & torch.roll(a2, -2, dims=0)
    a8 = a4 & torch.roll(a4, -4, dims=0)
    a9 = a8 & torch.roll(flags, -8, dims=0)
    return a9.any(dim=0)


def _margin(signed_diff, threshold):
    """Σ_i max(d_i − t, 0), added in circle order."""
    m = torch.clamp(signed_diff - threshold, min=0.0)
    acc = m[0]
    for i in range(1, m.shape[0]):
        acc = acc + m[i]
    return acc


def fast_score(img, threshold: float):
    """(H, W) FAST-9/16 response at one threshold: 0 where no arc of 9
    clears it, else the larger of the bright and the dark side's margin
    at that threshold. Border pixels (3 px) read wrapped values; callers
    mask a 16-px border (EDGE_THRESHOLD, src/ORBextractor.cpp:83)."""
    diff = _circle_diffs(img)
    neg = -diff
    margin = torch.maximum(_margin(diff, threshold), _margin(neg, threshold))
    corner = _arc_test(diff, threshold) | _arc_test(neg, threshold)
    return torch.where(corner, margin, torch.zeros_like(margin))


def fast_score_pair(img, t_high: float, t_low: float):
    """(score_high, score_low), both carrying the LOW-threshold margin
    ``max(Σmax(d−t_low,0), Σmax(−d−t_low,0))``: the threshold gates
    candidacy (the arc test), the score ranks corners within a cell."""
    diff = _circle_diffs(img)
    neg = -diff
    margin = torch.maximum(_margin(diff, t_low), _margin(neg, t_low))
    low_c = _arc_test(diff, t_low) | _arc_test(neg, t_low)
    high_c = _arc_test(diff, t_high) | _arc_test(neg, t_high)
    zero = torch.zeros_like(margin)
    return torch.where(high_c, margin, zero), torch.where(low_c, margin, zero)


def nms3x3(score):
    """3x3 non-maximum suppression (cv::FAST(..., true) semantics):
    keep ``s`` where ``s >= max3x3(s)`` and ``s > 0``, −∞ outside."""
    m = torch.nn.functional.max_pool2d(
        score[None, None], kernel_size=3, stride=1, padding=1
    )[0, 0]
    return torch.where((score >= m) & (score > 0.0), score, torch.zeros_like(score))
