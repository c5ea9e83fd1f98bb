"""``lax.top_k`` with its tie order, for the port's selections."""
from __future__ import annotations

import torch

__all__ = ["top_k"]


def top_k(x, k: int):
    """``lax.top_k`` along the last axis: descending, lower index first
    among equals (a stable sort; ``torch.topk`` documents no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
