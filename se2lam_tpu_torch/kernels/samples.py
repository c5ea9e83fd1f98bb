"""Seeded random inputs for holding a kernel against its plain version
(the card tests and ``chip_smoke.py`` share them). CPU tensors; the
caller moves them to the card."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["k2_inputs", "k2_robot_inputs"]


def k2_inputs(N1: int, N2: int, seed: int = 0, pool: int = 64):
    """``windowed_top2``'s ten arguments, rows and columns like the
    Localizer's: descriptors drawn from a pool of ``pool`` (so distances
    tie), projections and features over a 640x480 frame, windows of
    15-60 px, octave gates of ±2, and invalid rows and columns (invalid
    columns hold zero descriptors)."""
    rng = np.random.default_rng(seed)
    base = (1 - 2 * rng.integers(0, 2, (pool, 256))).astype(np.int8)
    d1 = base[rng.integers(0, pool, N1)]
    d2 = base[rng.integers(0, pool, N2)]
    v2 = rng.random(N2) > 0.1
    d2[~v2] = 0
    oct1 = rng.integers(0, 5, N1)
    x = [d1, rng.uniform(0, 640, (N1, 2)).astype(np.float32),
         (np.maximum(oct1, 1) * 15.0).astype(np.float32),
         np.maximum(oct1 - 2, 0).astype(np.float32), (oct1 + 2).astype(np.float32),
         rng.random(N1) > 0.3, d2,
         (rng.uniform(0, 1, (N2, 2)) * [640, 480]).astype(np.float32),
         rng.integers(0, 5, N2).astype(np.int32), v2]
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in x]


ROW_ARGS = (0, 2, 3, 4)   # the rows' descriptors, windows and octave gates


def k2_robot_inputs(B: int, N1: int, N2: int, seed: int = 0, pool: int = 64):
    """B robots' inputs on one shared bank of rows: robot b's are
    ``k2_inputs(N1, N2, seed + b, pool)`` with the rows' descriptors,
    windows and octave gates of robot 0. Returns (the batched arguments of
    ``windowed_top2_batched``, each robot's arguments of ``windowed_top2``)."""
    singles = [k2_inputs(N1, N2, seed=seed + b, pool=pool) for b in range(B)]
    rows = singles[0]
    one = [[rows[i] if i in ROW_ARGS else x[i] for i in range(10)] for x in singles]
    batched = [rows[i] if i in ROW_ARGS else torch.stack([x[i] for x in singles])
               for i in range(10)]
    return batched, one
