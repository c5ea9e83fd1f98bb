"""Schur point-block elimination, dispatched by device (port of
``se2lam_tpu/solver/ba.py:schur_reduce`` and its Pallas kernel
``solver/pallas_schur.py:schur_reduce_pallas``).

``point_reduction(Hpx, Hxx_inv)`` → S_red (K, K, 3, 3) with
S_red[k,l] = Σ_m Hpx[k,:,m,:] · Hxx⁻¹[m] · Hpx[l,:,m,:]ᵀ. A CPU tensor
runs the plain version (the einsum pair of ``ba.py:431-432``); a CUDA
tensor launches the hand-written kernel ``csrc/schur_reduce.cu`` or
raises. There is no fallback from the card to the plain version, and no
size routing: the TPU's thresholds (measured on a v5e) and its K ≤ 341
VMEM ceiling do not apply to the CUDA kernel.

``schur_reduce`` adds what JAX computes outside its kernel too: S =
Hpp − S_red and the reduced right-hand side, both as einsums, on either
device.

``point_reduction.launches`` counts kernel launches (CUDA calls only).
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import load_library

__all__ = ["point_reduction", "point_reduction_plain", "schur_reduce"]


def point_reduction_plain(Hpx, Hxx_inv):
    """The plain torch version of the kernel: the einsum pair."""
    T = torch.einsum("kamb,mbc->kamc", Hpx, Hxx_inv)
    return torch.einsum("kamb,lcmb->klac", T, Hpx)


def _kernel_fn():
    lib = load_library("schur_reduce")
    fn = lib.se2lam_schur_reduce
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def point_reduction(Hpx, Hxx_inv):
    """Hpx (K, 3, M, 3), Hxx_inv (M, 3, 3) f32 → S_red (K, K, 3, 3) f32."""
    if Hpx.device.type == "cpu":
        return point_reduction_plain(Hpx, Hxx_inv)
    if Hpx.device.type != "cuda":
        raise ValueError(f"point_reduction: unsupported device {Hpx.device}")
    K, M = Hpx.shape[0], Hpx.shape[2]
    ok = (
        Hpx.dtype == torch.float32 and Hxx_inv.dtype == torch.float32
        and Hpx.dim() == 4 and Hpx.shape[1] == 3 and Hpx.shape[3] == 3
        and tuple(Hxx_inv.shape) == (M, 3, 3)
        and Hpx.is_contiguous() and Hxx_inv.is_contiguous()
        and Hxx_inv.device == Hpx.device
    )
    if not ok:
        raise ValueError(
            "point_reduction: the kernel takes contiguous float32 Hpx (K,3,M,3) "
            f"and Hxx_inv (M,3,3) on one card, got {Hpx.dtype} {tuple(Hpx.shape)} "
            f"and {Hxx_inv.dtype} {tuple(Hxx_inv.shape)} on {Hxx_inv.device}"
        )
    fn = _kernel_fn()
    S = torch.empty((3 * K, 3 * K), dtype=torch.float32, device=Hpx.device)
    with torch.cuda.device(Hpx.device):
        stream = torch.cuda.current_stream(Hpx.device).cuda_stream
        err = fn(Hpx.data_ptr(), Hxx_inv.data_ptr(), S.data_ptr(), 3 * K, M, stream)
    if err != 0:
        raise RuntimeError(f"point_reduction: kernel launch failed, cudaError {err}")
    point_reduction.launches += 1
    return S.view(K, 3, K, 3).permute(0, 2, 1, 3)


point_reduction.launches = 0


def schur_reduce(Hpp, bp, Hpx, Hxx_inv, bx):
    """S = Hpp − Hpx·Hxx⁻¹·Hpxᵀ and b = bp − Hpx·Hxx⁻¹·bx. ``Hpx`` is
    (K, 3, M, 3) — [k,a],[m,b]. S_red comes from ``point_reduction`` and
    the right-hand side from y = Hxx⁻¹·bx, as the JAX package's kernel
    route computes them (``ba.py:428-430``)."""
    S_red = point_reduction(Hpx, Hxx_inv)
    y = torch.einsum("mab,mb->ma", Hxx_inv, bx)
    return Hpp - S_red, bp - torch.einsum("kamb,mb->ka", Hpx, y)
