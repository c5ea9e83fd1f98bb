"""FAST-9/16 + 3x3 NMS on pyramid levels, dispatched by device.

``fast_nms_levels(levels, t_high, t_low)`` takes a list of (H, W) f32
level images on one device and returns a list of ``(nms_high, nms_low,
raw_low)``, each (H, W) f32. A CPU list runs the plain version
(``fast.py``) level by level; a CUDA list launches the hand-written kernel
``csrc/fast_nms.cu`` once for each group of at most ``MAX_LEVELS`` levels
(once a frame at up to 8 pyramid levels), or raises. There is no fallback
from the card to the plain version. ``fast_nms(img, t_high, t_low)`` is
the one-level call.

The kernel replaces the TPU kernel
``se2lam_tpu/frontend/pallas_fast.py:fast_nms_pallas``, which the JAX
package calls once per level. The Pallas kernel and the XLA spelling in
``se2lam_tpu/frontend/fast.py`` agree only inside the 16-px border
(``pallas_fast.py:16-24``): the Pallas bands clamp their halo at the top
and bottom of the image, where ``fast.py`` wraps rows with ``roll``. The
CUDA kernel follows ``fast.py`` — rows and columns wrap for the circle
reads, NMS treats outside neighbours as −∞ — so it is bitwise equal to
this port's plain version over the whole map. Keypoint selection masks the
border, so the difference from the Pallas kernel is not observable
downstream.

``fast_nms.launches`` counts kernel launches (CUDA calls only): one per
group of levels.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import load_library
from .fast import fast_score_pair, nms3x3

__all__ = ["fast_nms", "fast_nms_levels", "fast_nms_levels_plain", "fast_nms_plain"]

MAX_LEVELS = 8   # the kernel's level table (kMaxLevels in csrc/fast_nms.cu)


class _Level(ctypes.Structure):
    """``Se2lamFastLevel`` of csrc/fast_nms.cu: one level's image and maps."""

    _fields_ = [("img", ctypes.c_void_p), ("hi", ctypes.c_void_p),
                ("lo", ctypes.c_void_p), ("raw", ctypes.c_void_p),
                ("H", ctypes.c_int), ("W", ctypes.c_int)]


def fast_nms_plain(img, t_high: float, t_low: float):
    """The plain torch version of the kernel on one level, on any device."""
    s_high, s_low = fast_score_pair(img, t_high, t_low)
    return nms3x3(s_high), nms3x3(s_low), s_low


def fast_nms_levels_plain(levels, t_high: float, t_low: float):
    """The plain version of ``fast_nms_levels``: level by level."""
    return [fast_nms_plain(lv, t_high, t_low) for lv in levels]


def _kernel_fn():
    lib = load_library("fast_nms")
    fn = lib.se2lam_fast_nms_levels
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(_Level), ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fast_nms_levels(levels, t_high: float, t_low: float):
    """List of (H, W) f32 level images on one device → list of
    ``(nms_high, nms_low, raw_low)``, each (H, W) f32. On the card the maps
    are views of one (3, Σ H·W) buffer, written by one launch."""
    levels = list(levels)
    if not levels:
        raise ValueError("fast_nms_levels: no level")
    dev = levels[0].device
    if any(lv.device != dev for lv in levels):
        raise ValueError("fast_nms_levels: the levels lie on more than one device: "
                         f"{sorted({str(lv.device) for lv in levels})}")
    if dev.type == "cpu":
        return fast_nms_levels_plain(levels, t_high, t_low)
    if dev.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {dev}")
    for lv in levels:
        if lv.dtype != torch.float32 or lv.dim() != 2 or not lv.is_contiguous():
            raise ValueError(
                "fast_nms: the kernel takes contiguous 2-D float32 tensors, got "
                f"{lv.dtype} {tuple(lv.shape)} contiguous={lv.is_contiguous()}")
    sizes = [lv.numel() for lv in levels]
    out = torch.empty((3, sum(sizes)), dtype=torch.float32, device=dev)
    maps = [part.view(3, *lv.shape).unbind(0)
            for lv, part in zip(levels, torch.split(out, sizes, dim=1))]
    rows = [_Level(lv.data_ptr(), hi.data_ptr(), lo.data_ptr(), raw.data_ptr(), *lv.shape)
            for lv, (hi, lo, raw) in zip(levels, maps)]
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g in range(0, len(rows), MAX_LEVELS):
            group = rows[g:g + MAX_LEVELS]
            err = fn(len(group), (_Level * len(group))(*group), float(t_high),
                     float(t_low), stream)
            if err != 0:
                raise RuntimeError(f"fast_nms: kernel launch failed, cudaError {err}")
            fast_nms.launches += 1
    return maps


def fast_nms(img, t_high: float, t_low: float):
    """(H, W) f32 image → (nms_high, nms_low, raw_low), each (H, W) f32: a
    one-level ``fast_nms_levels``."""
    return fast_nms_levels([img], t_high, t_low)[0]


fast_nms.launches = 0
