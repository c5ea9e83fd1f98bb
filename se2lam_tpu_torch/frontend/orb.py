"""ORB feature extraction as an ``nn.Module`` (port of
se2lam_tpu.frontend.orb; reference extractor src/ORBextractor.cpp:463-833).

Same observable behaviour as the JAX extractor — image pyramid through
constant resize matrices, per-cell FAST with high→low threshold fallback,
per-cell quotas with surplus redistribution as a two-phase priority
top-k, intensity-centroid orientation from disc-moment weights, and a
256-bit steered BRIEF with the 7x7 Gaussian blur folded into a 32-bin
pattern bank — written for a GPU:

- FAST+NMS runs in the hand-written CUDA kernel on the card, one launch
  for all pyramid levels of a frame (``fast_nms.py``), in its plain
  version on the CPU;
- the per-keypoint patch is a direct gather with clamped indices where
  the TPU version used one-hot matmuls; pixels are rounded through bf16
  as there, because the BRIEF bits depend on it;
- the bf16 products with f32 accumulation (moments, pattern bank) are
  f32 products of bf16-rounded operands with TF32 off: each term is
  exact, only the summation order differs;
- ``lax.top_k``'s tie order (lower index first) is reproduced with a
  stable descending sort.

Outputs are fixed-capacity padded tensors: every frame yields ``n_slots``
keypoint records with a validity mask.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.topk import top_k
from .fast_nms import fast_nms, fast_nms_levels
from .pattern import HALF_PATCH, N_BITS, PATTERN_X, PATTERN_Y

__all__ = ["OrbConfig", "OrbFeatures", "OrbExtractor", "make_batch_extractor", "pack_bits"]


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
    use_harris: bool = False  # rescore responses with Harris (the
    #                           reference's optional HarrisResponses,
    #                           src/ORBextractor.cpp:85-126; selection
    #                           stays FAST-ordered either way)

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


class OrbFeatures(NamedTuple):
    """Fixed-capacity keypoint + descriptor record for one frame."""

    xy: torch.Tensor        # (N, 2) f32 level-0 pixel coords (x, y)
    angle: torch.Tensor     # (N,) f32 radians
    octave: torch.Tensor    # (N,) int32
    response: torch.Tensor  # (N,) f32
    valid: torch.Tensor     # (N,) bool
    desc_bits: torch.Tensor  # (N, 8) uint32 packed 256-bit descriptor
    desc_pm1: torch.Tensor   # (N, 256) int8 ±1 view for matmul matching

    @property
    def n(self):
        return self.valid.sum(dtype=torch.int32)


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


def _harris_response(img, ys, xs, k: float = 0.04, block: int = 7):
    """Harris corner response at keypoint positions (the reference's
    optional HarrisResponses rescoring, src/ORBextractor.cpp:85-126), in
    the JAX package's order of operations: central-difference gradients
    (zero on the border), a separable ``block``-wide box sum of the
    second-moment products as ``block`` shifted adds left to right in
    each direction (zero padded), then a gather at the integer positions,
    clamped to the level as a JAX gather clamps. Written out of place, so
    ``torch.vmap`` batches it over frames."""
    H, W = img.shape
    pad = torch.nn.functional.pad
    gx = pad(0.5 * (img[:, 2:] - img[:, :-2]), (1, 1))
    gy = pad(0.5 * (img[2:, :] - img[:-2, :]), (0, 0, 1, 1))
    r = block // 2

    def box(x):
        ph = pad(x, (r, r))
        s = sum(ph[:, i: i + W] for i in range(block))
        pv = pad(s, (0, 0, r, r))
        return sum(pv[i: i + H] for i in range(block))

    scale = 1.0 / (4.0 * block * 255.0)   # the reference's 1/(4·blockSize·255)
    a = box(gx * gx) * (scale * scale)
    b = box(gy * gy) * (scale * scale)
    c = box(gx * gy) * (scale * scale)
    R = (a * b - c * c) - k * (a + b) * (a + b)
    return R[ys.clamp(0, H - 1), xs.clamp(0, W - 1)]


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


def pack_bits(bits):
    """(..., N, 256) {0,1} → (..., N, 8) uint32, little-endian within each
    word."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device),
    )
    words = (b * weights).sum(dim=-1)
    # to the int32 with the same bits, then reinterpret: uint32 tensors
    # have few ops in torch, a same-size view needs none
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).view(torch.uint32)


class OrbExtractor(torch.nn.Module):
    """(H, W) image → OrbFeatures. Buffers: the pyramid's resize matrices,
    the blur-folded BRIEF pattern bank and the IC_Angle moment weights.

    The bank and the moment weights hold bf16-rounded values stored as
    f32, so their products with the bf16-rounded patches are exact term by
    term, as the JAX version's bf16 operands with f32 accumulation are.
    """

    def __init__(self, cfg: OrbConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        for l, (Hl, Wl) in enumerate(cfg.level_shapes[1:], start=1):
            self.register_buffer(f"resize_h{l}", torch.from_numpy(
                _resize_matrix(Hl, cfg.height)).to(dev))
            self.register_buffer(f"resize_w{l}", torch.from_numpy(
                _resize_matrix(Wl, cfg.width)).to(dev))

        def bf16_rounded(a):
            return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).to(dev)

        self.register_buffer("pattern_bank", bf16_rounded(_pattern_bank()))
        self.register_buffer("moment_w", bf16_rounded(_moment_weights()))

    @property
    def device(self):
        return self.pattern_bank.device

    def pyramid(self, img):
        """List of level images: level 0 is ``img``, level l is
        ``Rh_l @ img @ Rw_lᵀ`` in f32."""
        levels = [img]
        for l in range(1, self.cfg.n_levels):
            Rh = getattr(self, f"resize_h{l}")
            Rw = getattr(self, f"resize_w{l}")
            levels.append((Rh @ img) @ Rw.T)
        return levels

    def extract_level(self, level_img, l: int, maps=None):
        """Keypoints of pyramid level ``l`` from its image; a dict of the
        level's slots (``quota`` of them), or None for a zero quota.
        ``maps`` are the level's FAST+NMS maps where the caller has them
        (``forward`` computes all levels' in one call), else computed here."""
        cfg = self.cfg
        quota = cfg.level_quotas[l]
        if quota <= 0:
            return None
        if maps is None:
            maps = fast_nms(level_img.contiguous(), cfg.fast_high, cfg.fast_low)
        nms_hi, nms_lo, sl_raw = maps
        ys, xs, ys_f, xs_f, resp, valid = _select_level_keypoints(
            cfg, nms_hi, nms_lo, sl_raw, quota
        )
        angle, bits = self._moments_and_bits(level_img, ys, xs)
        if cfg.use_harris:
            resp = _harris_response(level_img, ys, xs)
        scale = cfg.scales[l]
        return dict(
            xy=torch.stack([xs_f, ys_f], -1) * scale,
            angle=angle,
            octave=torch.full((quota,), l, dtype=torch.int32, device=ys.device),
            response=resp,
            valid=valid,
            bits=bits,
        )

    def _moments_and_bits(self, level_img, ys, xs):
        """One shared patch per keypoint → (angle, BRIEF bits)."""
        Q = ys.shape[0]
        patches = _extract_patches(level_img, ys, xs).reshape(Q, PATCH_S * PATCH_S)
        mom = patches @ self.moment_w                          # (Q, 2)
        angle = torch.atan2(mom[:, 1], mom[:, 0])
        resp = (patches @ self.pattern_bank).reshape(Q, N_ANGLE_BINS, N_BITS)
        binf = angle / (2.0 * math.pi) * N_ANGLE_BINS
        bin_idx = torch.remainder(torch.round(binf).to(torch.int64), N_ANGLE_BINS)
        sel = resp[torch.arange(Q, device=resp.device), bin_idx]   # (Q, 256)
        return angle, (sel > 0).to(torch.uint8)

    def forward(self, img) -> OrbFeatures:
        cfg = self.cfg
        img = torch.as_tensor(img, device=self.device).to(torch.float32)
        levels = self.pyramid(img)
        live = [l for l, q in enumerate(cfg.level_quotas) if q > 0]
        maps = fast_nms_levels([levels[l].contiguous() for l in live],
                               cfg.fast_high, cfg.fast_low)
        outs = [self.extract_level(levels[l], l, m) for l, m in zip(live, maps)]
        return _assemble(outs)

    def forward_batch(self, imgs) -> OrbFeatures:
        """(k, H, W) stack → OrbFeatures with a leading k axis, frame by
        frame the features of ``forward``. FAST+NMS takes every level of
        every frame in one ``fast_nms_levels`` call (⌈levels·k/8⌉ kernel
        launches); keypoint selection, orientation and BRIEF run under
        ``torch.func.vmap`` over the frames, so their launches do not grow
        with k. The pyramid alone is built frame by frame, with
        ``forward``'s own products: cuBLAS picks a product's kernel, and
        with it the order of its sums, by shape, so one product over the
        stacked frames would change a level pixel's last ulp against the
        frame alone and, through the subpixel refinement, the keyframes a
        trajectory inserts."""
        cfg = self.cfg
        imgs = torch.as_tensor(imgs, device=self.device).to(torch.float32)
        k = imgs.shape[0]
        levels = [torch.stack(lv) for lv in zip(*(self.pyramid(im) for im in imgs))]
        live = [l for l, q in enumerate(cfg.level_quotas) if q > 0]
        maps = fast_nms_levels([levels[l][f].contiguous() for l in live for f in range(k)],
                               cfg.fast_high, cfg.fast_low)
        outs = []
        for i, l in enumerate(live):
            m = maps[i * k:(i + 1) * k]
            stacked = [torch.stack([mf[j] for mf in m]) for j in range(3)]
            outs.append(torch.vmap(
                lambda im, hi, lo, raw, l=l: self.extract_level(im, l, (hi, lo, raw)))(
                    levels[l], *stacked))
        return _assemble(outs)


def _assemble(outs) -> OrbFeatures:
    """The levels' slot records (each with any leading axes) → OrbFeatures:
    concatenated along the slot axis, descriptors packed and as ±1."""
    cat = {k: torch.cat([o[k] for o in outs], dim=_slot_axis(k))
           for k in outs[0]}
    bits, valid = cat["bits"], cat["valid"]
    desc_pm1 = (1 - 2 * bits.to(torch.int8)).to(torch.int8)
    # zero out invalid slots so matchers can rely on masks alone
    desc_pm1 = torch.where(valid[..., None], desc_pm1, torch.zeros_like(desc_pm1))
    return OrbFeatures(
        xy=cat["xy"],
        angle=cat["angle"],
        octave=cat["octave"],
        response=cat["response"],
        valid=valid,
        desc_bits=pack_bits(bits),
        desc_pm1=desc_pm1,
    )


def _slot_axis(name):
    """The slot axis of a level record's field: last but one for the
    per-slot vectors (xy, bits), else the last."""
    return -2 if name in ("xy", "bits") else -1


def make_batch_extractor(cfg: OrbConfig, cam=None, undistort: bool = False, device=None):
    """(k, H, W) uint8 or f32 stack → OrbFeatures with a leading k axis
    (port of se2lam_tpu/frontend/orb.py:make_batch_extractor): the stack
    goes to the device as it is and is cast to f32 there, then
    ``OrbExtractor.forward_batch``; with ``undistort`` the keypoints are
    undistorted through ``cam`` as the per-frame path does. The JAX
    version maps the frames one by one (``lax.map``) to bound a TPU's
    memory; here the frames run batched."""
    ext = OrbExtractor(cfg, device=device)
    if undistort:
        from ..ops.camera import undistort_points

    def extract(img_stack):
        if not torch.is_tensor(img_stack):
            img_stack = torch.from_numpy(np.asarray(img_stack))
        feats = ext.forward_batch(img_stack.to(ext.device))
        if undistort:
            feats = feats._replace(xy=undistort_points(cam, feats.xy))
        return feats

    extract.extractor = ext
    return extract
