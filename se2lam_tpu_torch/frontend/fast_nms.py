"""FAST-9/16 + 3x3 NMS on one pyramid level, dispatched by device.

``fast_nms(img, t_high, t_low)`` → ``(nms_high, nms_low, raw_low)``, each
(H, W) f32. A CPU tensor runs the plain version (``fast.py``); a CUDA
tensor launches the hand-written kernel ``csrc/fast_nms.cu`` or raises.
There is no fallback from the card to the plain version.

The kernel replaces the TPU kernel
``se2lam_tpu/frontend/pallas_fast.py:fast_nms_pallas``. The Pallas kernel
and the XLA spelling in ``se2lam_tpu/frontend/fast.py`` agree only inside
the 16-px border (``pallas_fast.py:16-24``): the Pallas bands clamp their
halo at the top and bottom of the image, where ``fast.py`` wraps rows
with ``roll``. The CUDA kernel follows ``fast.py`` — rows and columns wrap
for the circle reads, NMS treats outside neighbours as −∞ — so it is
bitwise equal to this port's plain version over the whole map. Keypoint
selection masks the border, so the difference from the Pallas kernel is
not observable downstream.

``fast_nms.launches`` counts kernel launches (CUDA calls only).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import load_library
from .fast import fast_score_pair, nms3x3

__all__ = ["fast_nms", "fast_nms_plain"]


def fast_nms_plain(img, t_high: float, t_low: float):
    """The plain torch version of the kernel, on any device."""
    s_high, s_low = fast_score_pair(img, t_high, t_low)
    return nms3x3(s_high), nms3x3(s_low), s_low


def _kernel_fn():
    lib = load_library("fast_nms")
    fn = lib.se2lam_fast_nms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def fast_nms(img, t_high: float, t_low: float):
    """(H, W) f32 image → (nms_high, nms_low, raw_low), each (H, W) f32."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, t_high, t_low)
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(
            "fast_nms: the kernel takes a contiguous 2-D float32 tensor, got "
            f"{img.dtype} {tuple(img.shape)} contiguous={img.is_contiguous()}"
        )
    H, W = img.shape
    fn = _kernel_fn()
    hi, lo, raw = (torch.empty_like(img) for _ in range(3))
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), hi.data_ptr(), lo.data_ptr(), raw.data_ptr(),
                 H, W, float(t_high), float(t_low), stream)
    if err != 0:
        raise RuntimeError(f"fast_nms: kernel launch failed, cudaError {err}")
    fast_nms.launches += 1
    return hi, lo, raw


fast_nms.launches = 0
