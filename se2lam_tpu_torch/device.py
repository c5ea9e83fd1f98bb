"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA request without a GPU raises; nothing
    falls back to the CPU unless the caller names it.

    On CUDA this also turns TF32 off for matmuls and cuDNN: the JAX
    reference computes its f32 products at full precision, and the
    extractor's pyramid and pattern-bank products rely on it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "se2lam_tpu_torch: CUDA requested (device=None means cuda) "
                "but torch.cuda.is_available() is False; pass device='cpu' "
                "explicitly to run the plain versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
