"""BRIEF sampling pattern for the steered-BRIEF descriptor (the port's own
copy of se2lam_tpu.frontend.pattern; the same seed gives the same table,
which tests/test_torch_orb.py checks bitwise).

The reference bakes the ORB paper's learned 256-pair pattern
(src/ORBextractor.cpp:203-461, ``bit_pattern_31_``). We deliberately do NOT
reuse that table: this framework is self-consistent end to end (its own
extractor, matcher, and vocabulary), so any well-spread pattern works, and
generating our own keeps the implementation clean-room. Pairs are drawn
from the isotropic Gaussian N(0, (patch/5)²) recommended in the original
BRIEF/ORB papers, clamped to the 31x31 patch, with a fixed seed so the
descriptor layout is stable across processes and checkpoints.
"""
from __future__ import annotations

import numpy as np

PATCH_SIZE = 31
HALF_PATCH = 15
N_BITS = 256

_rng = np.random.default_rng(0x5E21A7)  # stable, version-locked seed
_sigma = PATCH_SIZE / 5.0
_raw = _rng.normal(0.0, _sigma, size=(N_BITS, 2, 2))
# clamp inside the orientation-safe disc (radius 13 keeps rotated samples
# within the 31x31 patch for any angle, |p|*sqrt(2) < 15 guard not needed
# since we clamp radius directly)
_norm = np.linalg.norm(_raw, axis=-1, keepdims=True)
_max_r = 13.0
_raw = np.where(_norm > _max_r, _raw * (_max_r / np.maximum(_norm, 1e-9)), _raw)
PATTERN = np.round(_raw).astype(np.int32)  # (256, 2, 2): [bit, (p|q), (x|y)]

# flattened views used by the extractor
PATTERN_X = PATTERN[..., 0].reshape(-1).astype(np.float32)  # (512,)
PATTERN_Y = PATTERN[..., 1].reshape(-1).astype(np.float32)  # (512,)
