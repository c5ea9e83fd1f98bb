"""Plain ORB extraction, the reference the benchmark holds the port's
extractor to: a frozen copy of the plain torch path of
``se2lam_tpu_torch/frontend/{orb,fast,pattern}.py`` and ``ops/topk.py``
(FAST-9/16 scores and 3x3 NMS as torch ops, cell quotas, intensity-centroid
angle, steered BRIEF through the blur-folded pattern bank), with no import
of the port. It runs on any device; on the card with TF32 off it computes
what the port's extractor must, K1's maps included (K1 is bitwise its plain
version). ``tf32=True`` runs its products in TF32: the benchmark's control.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

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


def top_k(x, k: int):
    """``lax.top_k`` along the last axis: descending, lower index first
    among equals (a stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_maps(img, t_high: float, t_low: float):
    """K1's three maps of one level: (nms_high, nms_low, raw_low)."""
    s_high, s_low = fast_score_pair(img, t_high, t_low)
    return nms3x3(s_high), nms3x3(s_low), s_low


class OrbConfig(NamedTuple):
    """Static extractor configuration (Settings.yml: max_feature_num,
    scale_facotr [sic], max_level — src/Config.cpp:137-139)."""

    height: int
    width: int
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 5
    fast_high: float = 20.0   # reference fastTh default
    fast_low: float = 7.0     # fallback threshold (src/ORBextractor.cpp:621)
    min_high_corners: int = 3  # "<=3 → retry at low th"
    edge: int = 16            # EDGE_THRESHOLD border exclusion
    features_per_cell: int = 3

    @property
    def scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    @property
    def level_sigma2(self):
        return np.asarray([s * s for s in self.scales], np.float32)

    @property
    def level_quotas(self) -> Sequence[int]:
        """Geometric per-level feature budget (src/ORBextractor.cpp:484-494)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        quotas = [int(round(n0 * (f ** l))) for l in range(self.n_levels - 1)]
        quotas.append(max(self.n_features - sum(quotas), 0))
        return quotas

    @property
    def n_slots(self) -> int:
        return sum(self.level_quotas)

    @property
    def level_shapes(self):
        return [
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.scales
        ]


def _gauss_kernel7(sigma=2.0):
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


_GAUSS7 = _gauss_kernel7()

# per-row half-width of the radius-15 disc (the umax table the reference
# builds at src/ORBextractor.cpp:476-492)
_DISC_U = [
    int(math.floor(math.sqrt(HALF_PATCH * HALF_PATCH - dy * dy)))
    for dy in range(-HALF_PATCH, HALF_PATCH + 1)
]

# Patch radius: rotated pattern samples live in [−14, 14]; the folded blur
# stamp adds 3 → R = 17. The radius-15 IC_Angle disc also fits.
N_ANGLE_BINS = 32
PATCH_R = 17
PATCH_S = 2 * PATCH_R + 1


def _pattern_bank():
    """(S², B·256) weights: column (b·256+j) compares pattern pair j under
    bin-b rotation, through the folded 7x7 Gaussian blur."""
    B, S, R = N_ANGLE_BINS, PATCH_S, PATCH_R
    W = np.zeros((S * S, B, N_BITS), np.float32)
    px = np.asarray(PATTERN_X, np.float64)
    py = np.asarray(PATTERN_Y, np.float64)
    g2 = np.outer(_GAUSS7, _GAUSS7).astype(np.float64)   # (7, 7)
    signs = np.where(np.arange(2 * N_BITS) % 2 == 0, -1.0, 1.0)  # p, q, p, q…
    bits = np.arange(2 * N_BITS) // 2
    for b in range(B):
        th = 2.0 * np.pi * b / B
        c, s = np.cos(th), np.sin(th)
        rx = np.round(px * c - py * s).astype(np.int64) + R
        ry = np.round(px * s + py * c).astype(np.int64) + R
        # keep the whole blur stamp inside the patch
        rx = np.clip(rx, 3, S - 4)
        ry = np.clip(ry, 3, S - 4)
        for iy in range(7):
            for ix in range(7):
                flat = (ry + iy - 3) * S + (rx + ix - 3)
                np.add.at(W, (flat, b, bits), signs * g2[iy, ix])
    return W.reshape(S * S, B * N_BITS).astype(np.float32)


def _moment_weights():
    """(S², 2) constant [x, y] disc weights for IC_Angle: contracting a
    flattened keypoint patch against this gives (m10, m01) exactly as the
    reference's disc sums (src/ORBextractor.cpp:130-157)."""
    w = np.zeros((PATCH_S, PATCH_S, 2), np.float32)
    for i, dy in enumerate(range(-HALF_PATCH, HALF_PATCH + 1)):
        u = _DISC_U[i]
        for dx in range(-u, u + 1):
            w[PATCH_R + dy, PATCH_R + dx, 0] = dx
            w[PATCH_R + dy, PATCH_R + dx, 1] = dy
    return w.reshape(PATCH_S * PATCH_S, 2)


def _resize_matrix(n_out: int, n_in: int):
    """(n_out, n_in) antialiased-linear resampling weights (the triangle
    kernel widened by the downscale factor)."""
    s = n_in / n_out
    support = max(1.0, s)
    R = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        c = (i + 0.5) * s - 0.5
        lo = int(math.floor(c - support))
        hi = int(math.ceil(c + support))
        for j in range(lo, hi + 1):
            w = max(0.0, 1.0 - abs(j - c) / support)
            R[i, min(max(j, 0), n_in - 1)] += w
    R /= R.sum(axis=1, keepdims=True)
    return R.astype(np.float32)


def _level_grid(cfg: OrbConfig, H: int, W: int, quota: int):
    """Static cell layout for one pyramid level (levelCols/levelRows at
    src/ORBextractor.cpp:542-556)."""
    Hv, Wv = H - 2 * cfg.edge, W - 2 * cfg.edge
    ncx = max(1, int(round(math.sqrt(quota * Wv / (cfg.features_per_cell * max(Hv, 1))))))
    ncy = max(1, int(round(ncx * Hv / max(Wv, 1))))
    cell_h = -(-Hv // ncy)
    cell_w = -(-Wv // ncx)
    return ncy, ncx, cell_h, cell_w


def _select_level_keypoints(cfg: OrbConfig, s_high, s_low, s_low_raw,
                            quota: int):
    """Cell quotas + redistribution over precomputed FAST score maps.

    s_high/s_low: NMS'd score maps at the two thresholds; s_low_raw: the
    raw (pre-NMS) low-threshold map for subpixel refinement. Returns
    (ys, xs, ys_f, xs_f, response, valid) each (quota,) in level pixels.
    """
    H, W = s_high.shape
    e = cfg.edge
    ncy, ncx, ch, cw = _level_grid(cfg, H, W, quota)

    def to_cells(s):
        # the border mask is the interior slice; padding is zero
        v = s[e : H - e, e : W - e]
        v = torch.nn.functional.pad(
            v, (0, ncx * cw - (W - 2 * e), 0, ncy * ch - (H - 2 * e))
        )
        return v.reshape(ncy, ch, ncx, cw).permute(0, 2, 1, 3).reshape(
            ncy * ncx, ch * cw
        )

    cells_high = to_cells(s_high)
    cells_low = to_cells(s_low)

    # per-cell high→low threshold fallback (src/ORBextractor.cpp:618-622)
    n_high = (cells_high > 0).sum(dim=1)
    use_high = (n_high > cfg.min_high_corners)[:, None]
    cells = torch.where(use_high, cells_high, cells_low)

    n_cells = ncy * ncx
    # two-phase priority: each cell's best candidate outranks every cell's
    # k-th; the score breaks ties within a tier (FAST scores ≤ 16·255 <
    # 8192 keep the tier stride f32-exact)
    k_cell = max(2, min(6, -(-2 * quota // n_cells)))
    top_scores, top_idx = top_k(cells, k_cell)            # (n_cells, k)
    rank = torch.arange(k_cell, device=cells.device)[None, :]
    tier = (k_cell - rank).to(top_scores.dtype) * 8192.0
    priority = torch.where(
        top_scores > 0.0,
        tier + torch.clamp(top_scores, max=8191.0),
        torch.full_like(top_scores, -math.inf),
    )

    sel_p, sel = top_k(priority.reshape(-1), quota)
    valid = sel_p > 0.0
    # cell id, rank and score unpack from the flat index and the key
    r_sel = sel % k_cell
    cid = sel // k_cell
    resp = torch.where(
        valid,
        sel_p - (k_cell - r_sel).to(sel_p.dtype) * 8192.0,
        torch.zeros_like(sel_p),
    )
    within = top_idx.reshape(-1)[sel]
    cy, cx = cid // ncx, cid % ncx
    wy, wx = within // cw, within % cw
    ys = e + cy * ch + wy
    xs = e + cx * cw + wx

    # subpixel refinement: 1D parabola through the raw FAST score at the
    # corner and its 4-neighbours (reported coordinates only)
    nb = _gather3x3(s_low_raw, ys, xs)
    s_c = nb[:, 1, 1]
    s_l, s_r = nb[:, 1, 0], nb[:, 1, 2]
    s_u, s_d = nb[:, 0, 1], nb[:, 2, 1]
    denom_x = s_l - 2.0 * s_c + s_r
    denom_y = s_u - 2.0 * s_c + s_d
    zero = torch.zeros_like(s_c)
    dx_sub = torch.where(denom_x.abs() > 1e-6, 0.5 * (s_l - s_r) / denom_x, zero)
    dy_sub = torch.where(denom_y.abs() > 1e-6, 0.5 * (s_u - s_d) / denom_y, zero)
    xs_f = xs.to(torch.float32) + torch.clamp(dx_sub, -0.5, 0.5)
    ys_f = ys.to(torch.float32) + torch.clamp(dy_sub, -0.5, 0.5)
    return ys, xs, ys_f, xs_f, resp, valid


def _gather3x3(mapv, ys, xs):
    """(Q, 3, 3) neighbourhoods of a dense map at integer centres, with
    indices clamped to the map."""
    H, W = mapv.shape
    d = torch.arange(-1, 2, device=mapv.device)
    rows = torch.clamp(ys[:, None] + d[None, :], 0, H - 1)      # (Q, 3)
    cols = torch.clamp(xs[:, None] + d[None, :], 0, W - 1)
    return mapv[rows[:, :, None], cols[:, None, :]]


def _extract_patches(img, ys, xs):
    """(Q, S, S) patches at integer centres, clamped to the border, with the
    pixel values rounded through bf16 (exact for 8-bit integers, ≤0.5 gray
    on the interpolated upper levels), returned as f32."""
    H, W = img.shape
    d = torch.arange(-PATCH_R, PATCH_R + 1, device=img.device)
    rows = torch.clamp(ys[:, None] + d[None, :], 0, H - 1)      # (Q, S)
    cols = torch.clamp(xs[:, None] + d[None, :], 0, W - 1)      # (Q, S)
    imgb = img.to(torch.bfloat16).to(torch.float32)
    return imgb[rows[:, :, None], cols[:, None, :]]


class PlainOrb:
    """(H, W) image → dict of the keypoint slots (``xy``, ``octave``,
    ``valid``, ``bits`` (N, 256) uint8), the port's ``OrbExtractor.forward``
    written plainly. ``tf32``: the products (pyramid, moments, pattern
    bank) in TF32, the precision below the configuration's."""

    def __init__(self, cfg: OrbConfig, device, tf32: bool = False):
        self.cfg, self.device, self.tf32 = cfg, torch.device(device), tf32
        self.resize = [
            (torch.from_numpy(_resize_matrix(Hl, cfg.height)).to(self.device),
             torch.from_numpy(_resize_matrix(Wl, cfg.width)).to(self.device))
            for Hl, Wl in cfg.level_shapes[1:]]

        def bf16_rounded(a):
            return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).to(self.device)

        self.pattern_bank = bf16_rounded(_pattern_bank())
        self.moment_w = bf16_rounded(_moment_weights())

    def __call__(self, img):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            return self._extract(torch.as_tensor(img, device=self.device).to(torch.float32))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _extract(self, img):
        cfg = self.cfg
        levels = [img] + [(Rh @ img) @ Rw.T for Rh, Rw in self.resize]
        outs = []
        for l, quota in enumerate(cfg.level_quotas):
            if quota <= 0:
                continue
            lv = levels[l].contiguous()
            hi, lo, raw = nms_maps(lv, cfg.fast_high, cfg.fast_low)
            ys, xs, ys_f, xs_f, _resp, valid = _select_level_keypoints(cfg, hi, lo, raw, quota)
            Q = ys.shape[0]
            patches = _extract_patches(lv, ys, xs).reshape(Q, PATCH_S * PATCH_S)
            mom = patches @ self.moment_w
            angle = torch.atan2(mom[:, 1], mom[:, 0])
            resp = (patches @ self.pattern_bank).reshape(Q, N_ANGLE_BINS, N_BITS)
            binf = angle / (2.0 * math.pi) * N_ANGLE_BINS
            bin_idx = torch.remainder(torch.round(binf).to(torch.int64), N_ANGLE_BINS)
            sel = resp[torch.arange(Q, device=resp.device), bin_idx]
            outs.append(dict(
                xy=torch.stack([xs_f, ys_f], -1) * cfg.scales[l],
                octave=torch.full((Q,), l, dtype=torch.int32, device=ys.device),
                valid=valid, bits=(sel > 0).to(torch.uint8)))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
