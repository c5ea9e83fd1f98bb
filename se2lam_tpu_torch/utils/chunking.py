"""Chunk helpers shared by ``SlamSystem.process_chunk`` and
``Localizer.process_chunk``. The JAX package's ``pad_chunk``
(se2lam_tpu/utils/chunking.py) pads a short chunk to one compiled size;
eager torch compiles nothing, so the port feeds only a chunk's live
frames."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_chunk", "stack_images"]


def check_chunk(imgs, odos):
    """A chunk needs one odometry reading per image."""
    if len(imgs) != len(odos):
        raise ValueError(f"a chunk of {len(imgs)} images and {len(odos)} odometry readings")


def stack_images(imgs, device) -> torch.Tensor:
    """A chunk's images as one (k, H, W) tensor on ``device``, in their own
    dtype (uint8 frames cross at one byte a pixel)."""
    if all(torch.is_tensor(im) for im in imgs):
        return torch.stack([im.to(device) for im in imgs])
    return torch.from_numpy(np.stack([np.asarray(im) for im in imgs])).to(device)
