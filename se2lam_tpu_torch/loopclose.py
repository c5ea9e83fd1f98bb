"""Loop closing (port of se2lam_tpu.loopclose; reference GlobalMapper,
src/GlobalMapper.cpp).

Only ``kf_features`` is here so far, which relocalization uses. Loop
detection and verification, the constraint sparsifier, map-point fusion
and the global BAs follow with loop closing (``ROADMAP.md`` §1, item 15).
"""
from __future__ import annotations

import torch

from .frontend.orb import OrbFeatures
from .localmap import _row
from .mapstate import MapState

__all__ = ["kf_features"]


def kf_features(ms: MapState, k) -> OrbFeatures:
    """A stored keyframe's features as an OrbFeatures record; ``k`` may be
    an int or a 0-d tensor on the map's device."""
    N, dev = ms.N, ms.kf_xy.device
    return OrbFeatures(
        xy=_row(ms.kf_xy, k),
        angle=_row(ms.kf_angle, k),
        octave=_row(ms.kf_octave, k),
        response=torch.ones((N,), dtype=ms.kf_xy.dtype, device=dev),
        valid=_row(ms.kf_feat_valid, k),
        desc_bits=torch.zeros((N, 8), dtype=torch.int32, device=dev).view(torch.uint32),
        desc_pm1=_row(ms.kf_desc, k),
    )
