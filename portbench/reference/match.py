"""Plain reference of the gated top-2 descriptor match the port's K2
computes: for each row (a projected map point), the two nearest columns
(frame features) in Hamming distance among those inside its pixel window
and octave range. Plain torch, with no import of the port; the lowest
column wins a tie."""
from __future__ import annotations

import torch

__all__ = ["windowed_top2"]

_BIG = 1e9


def windowed_top2(d1_pm1, xy_pred, win, lvl_lo, lvl_hi, valid1, d2_pm1, xy2, oct2, valid2,
                  gate_dtype=torch.float32):
    """(best, second, argbest, argsecond) per row; a row with no admitted
    column reads (1e9, 1e9, 0, 0). ``gate_dtype``: the precision of the
    window test (float16 is the benchmark's control)."""
    D = (256.0 - d1_pm1.to(torch.float32) @ d2_pm1.to(torch.float32).T) * 0.5
    a, b = xy_pred.to(gate_dtype), xy2.to(gate_dtype)
    w = win.to(gate_dtype)[:, None]
    o2 = oct2.to(torch.float32)[None, :]
    gate = (((b[None, :, 0] - a[:, None, 0]).abs() <= w)
            & ((b[None, :, 1] - a[:, None, 1]).abs() <= w)
            & (o2 >= lvl_lo[:, None]) & (o2 <= lvl_hi[:, None])
            & valid1[:, None] & valid2[None, :])
    Dm = torch.where(gate, D, torch.full_like(D, _BIG))
    best, arg = Dm.min(dim=1).values, torch.argmin(Dm, dim=1)
    cols = torch.arange(Dm.shape[1], device=Dm.device)
    Dm = torch.where(cols[None, :] == arg[:, None], torch.full_like(Dm, _BIG), Dm)
    second, arg2 = Dm.min(dim=1).values, torch.argmin(Dm, dim=1)
    return best, second, arg.to(torch.int32), arg2.to(torch.int32)


def rows_differing(got, want) -> int:
    """Rows where any of the four outputs differs."""
    diff = torch.zeros_like(got[0], dtype=torch.bool)
    for g, w in zip(got, want):
        diff |= g.to(w.dtype) != w
    return int(diff.sum())
