"""A device mesh for the distributed solvers (port of
se2lam_tpu/parallel/mesh.py, with the collectives that JAX's ``shard_map``
inserts made explicit).

One controller drives every block, as one JAX process drives every device
of a ``jax.sharding.Mesh``: a sharded value is a list with one tensor per
block, each on its block's device; a ``shard_map`` body becomes a loop over
the blocks between collectives (on separate cards the blocks' launches
overlap, CUDA launches being asynchronous); ``psum`` sums the blocks'
partials in block order 0..n-1 on the first block's device, a fixed order,
and hands each block a copy.

A mesh is either n CUDA cards (``make_mesh(n)``) or n blocks on one device
(``make_mesh(n, device=...)``): the counterpart of the forced host-device
count the JAX tests run on, and how one card runs an n-way mesh. After
``runtime.init_distributed`` a mesh may also span processes
(``runtime.global_mesh``): ``psum`` then adds a ``torch.distributed``
all-reduce of the local sum.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["Mesh", "make_mesh", "gather"]


class Mesh:
    """An ordered tuple of ``torch.device``s, one per block this process
    holds, and one axis name. Within one process (``make_mesh``) the mesh
    is those blocks. Across processes (``runtime.global_mesh``) every
    process holds ``len(devices)`` consecutive blocks, process ``rank``
    blocks ``rank·len(devices)`` on, and ``group`` is the
    ``torch.distributed`` group they share."""

    def __init__(self, devices, axis: str = "d", group=None, rank: int = 0,
                 n_processes: int = 1):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one block")
        self.axis_names = (axis,)
        self.group = group
        self.rank = rank
        self.n_processes = n_processes

    @property
    def size(self) -> int:
        """Blocks of the whole mesh, every process's."""
        return len(self.devices) * self.n_processes

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_names[0]!r}, "
                f"rank={self.rank} of {self.n_processes})")

    def local(self, blocks):
        """Of a list of all ``size`` blocks, this process's, each moved to
        its block's device."""
        if len(blocks) != self.size:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {self.size}")
        first = self.rank * len(self.devices)
        return [b.to(d) for b, d in zip(blocks[first:first + len(self.devices)], self.devices)]

    def _reduce(self, x):
        """The local blocks' tensors summed in block order on the first
        device, then across processes."""
        d0 = self.devices[0]
        acc = x[0].to(d0)
        for part in x[1:]:
            acc = acc + part.to(d0)
        if self.group is not None:
            import torch.distributed as dist

            acc = acc.clone()
            dist.all_reduce(acc, group=self.group)
        return acc

    def psum(self, parts):
        """``jax.lax.psum`` over the axis: ``parts`` has one entry per local
        block (a tensor or a tuple of tensors). Returns the sum, one copy
        per block on its device (a tuple's entries summed one by one)."""
        if len(parts) != len(self.devices):
            raise ValueError(f"psum: {len(parts)} parts for {len(self.devices)} blocks")
        if isinstance(parts[0], (tuple, list)):
            sums = [self._reduce([p[i] for p in parts]) for i in range(len(parts[0]))]
            return [tuple(s.to(d) for s in sums) for d in self.devices]
        s = self._reduce(parts)
        return [s.to(d) for d in self.devices]

    def replicate(self, x):
        """A replicated value: one copy per local block on its device."""
        return [x.to(d) for d in self.devices]

    def split(self, x, dim: int = 0):
        """``x`` cut into ``size`` equal contiguous blocks along ``dim``;
        this process's, each on its block's device (``shard_fleet``'s
        layout)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"the mesh's {self.size} blocks do not divide axis {dim} "
                             f"of length {x.shape[dim]}")
        return self.local(list(x.chunk(self.size, dim)))

    def all_blocks(self, blocks):
        """Every process's blocks, in block order, from this process's
        (equal shapes; an all-gather across processes)."""
        if self.group is None:
            return list(blocks)
        import torch.distributed as dist

        mine = torch.stack([b.to(self.devices[0]) for b in blocks])
        got = [torch.empty_like(mine) for _ in range(self.n_processes)]
        dist.all_gather(got, mine, group=self.group)
        return [b for g in got for b in g.unbind(0)]


def gather(blocks, device=None):
    """A block list put back into the JAX package's concatenated layout
    (block b's rows after block b-1's), on ``device`` (the first block's by
    default)."""
    dev = blocks[0].device if device is None else torch.device(device)
    return torch.cat([b.to(dev) for b in blocks])


def make_mesh(n_devices: int | None = None, axis: str = "d", device=None) -> Mesh:
    """A 1-D mesh. Without ``device``: the first ``n_devices`` CUDA cards
    (all of them for None), raising if there are fewer. With ``device``:
    ``n_devices`` blocks (1 for None) on that one device. ``device=None``
    never means the CPU."""
    if device is None:
        resolve_device(None)                  # raises without a card
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if have < n:
            raise ValueError(f"need {n} devices, have {have}")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh([dev] * (1 if n_devices is None else n_devices), axis)
