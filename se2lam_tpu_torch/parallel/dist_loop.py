"""Distributed loop-closure detection: a keyframe bank split over the mesh
(port of se2lam_tpu/parallel/dist_loop.py).

The per-keyframe BoW bank (or a ±1 descriptor bank) lives as a
``ShardedRows``: one block of consecutive rows per mesh block, each on its
device. Scoring a query is each block's own product and its local best;
the blocks' bests meet on the first device, where the lowest row of the
best score wins, as ``jnp.argmax`` / ``jnp.argmin`` pick. The scores come
from the port's own ``vocab.bow_score`` and ``frontend.matcher``'s Hamming
convention, so the metric cannot drift from the single-device path.
"""
from __future__ import annotations

import math

import torch

from ..frontend.matcher import hamming_matrix
from ..vocab import bow_score
from .mesh import Mesh, gather

__all__ = ["ShardedRows", "shard_bank", "sharded_bow_detect", "sharded_hamming_detect"]


class ShardedRows:
    """A (K, …) bank as ``mesh.size`` blocks of K/n consecutive rows, this
    process's blocks on their devices."""

    def __init__(self, blocks, mesh: Mesh):
        self.blocks = list(blocks)
        self.mesh = mesh
        self.rows = self.blocks[0].shape[0]

    @property
    def shape(self):
        return (self.rows * self.mesh.size,) + tuple(self.blocks[0].shape[1:])

    def _first_row(self) -> int:
        return self.mesh.rank * len(self.mesh.devices) * self.rows

    def put_row(self, k: int, v) -> "ShardedRows":
        """``bank.at[k].set(v)``: a new bank whose row ``k`` is ``v`` (a row
        held by another process is that process's to write)."""
        b, i = divmod(int(k) - self._first_row(), self.rows)
        blocks = list(self.blocks)
        if 0 <= b < len(blocks):
            blk = blocks[b].clone()
            blk[i] = v.to(blk.device, blk.dtype)
            blocks[b] = blk
        return ShardedRows(blocks, self.mesh)

    def gather(self, device=None):
        """The whole bank in one tensor (every process's rows)."""
        return gather(self.mesh.all_blocks(self.blocks), device or self.mesh.devices[0])


def shard_bank(bank, mesh: Mesh, axis: str = "d") -> ShardedRows:
    """Place a (K, W) BoW bank (or a (K, 256) descriptor bank) with the
    keyframe axis split over ``mesh``. K must be a multiple of the mesh's
    size (pad with invalid rows upstream)."""
    return ShardedRows(mesh.split(bank, 0), mesh)


def _rows(bank, x):
    """The block list of ``x`` (K, …) matching ``bank``'s layout."""
    if isinstance(bank, ShardedRows):
        if isinstance(x, ShardedRows):
            return x.blocks
        return bank.mesh.local(list(x.chunk(bank.mesh.size)))
    return [x]


def _best(bank, values, largest: bool):
    """(row, value) of the best over the blocks' (rows,) values: the
    lowest row among the ties, as ``jnp.argmax``/``argmin``."""
    if isinstance(bank, ShardedRows):
        offs = bank._first_row()
        d0 = bank.mesh.devices[0]
        pick = []
        for b, s in enumerate(values):
            i = torch.argmax(s) if largest else torch.argmin(s)
            pick.append(torch.stack([s[i].to(torch.float64), (i + offs + b * bank.rows)
                                     .to(torch.float64)]).to(d0))
        pick = torch.stack(bank.mesh.all_blocks(pick))
        best = pick[:, 0].max() if largest else pick[:, 0].min()
        j = torch.argmax((pick[:, 0] == best).to(torch.int32))    # first block with it
        return pick[j, 1].to(torch.int64), pick[j, 0].to(values[0].dtype)
    s = values[0]
    i = torch.argmax(s) if largest else torch.argmin(s)
    return i, s[i]


def sharded_bow_detect(bank, query, eligible):
    """(best row, best score) of the DBoW2 L1 score of ``query`` (W,)
    against the eligible rows of ``bank`` (a ``ShardedRows`` or one (K, W)
    tensor); ineligible rows score −inf."""
    blocks = bank.blocks if isinstance(bank, ShardedRows) else [bank]
    elig = _rows(bank, eligible)
    scores = [torch.where(e.to(b.device), bow_score(b, query.to(b.device)),
                          torch.full((b.shape[0],), -math.inf, device=b.device))
              for b, e in zip(blocks, elig)]
    return _best(bank, scores, largest=True)


def sharded_hamming_detect(desc_bank, query_desc, valid=None):
    """Nearest row of a ±1 descriptor bank (``ShardedRows`` or one tensor)
    to ``query_desc`` (1, 256): (row, Hamming distance). ``valid`` masks
    padded or pruned rows (a zeroed ±1 row is 128 from any query, and
    would win a miss)."""
    blocks = desc_bank.blocks if isinstance(desc_bank, ShardedRows) else [desc_bank]
    masks = [None] * len(blocks) if valid is None else _rows(desc_bank, valid)
    dists = []
    for b, m in zip(blocks, masks):
        d = hamming_matrix(b, query_desc.to(b.device))[:, 0]
        if m is not None:
            d = torch.where(m.to(b.device), d, torch.full_like(d, math.inf))
        dists.append(d)
    return _best(desc_bank, dists, largest=False)
