"""Multi-process runtime: ``torch.distributed`` initialization and a mesh
over every process's blocks (port of se2lam_tpu/parallel/runtime.py).

Each process runs the same program on its own blocks; the mesh's ``psum``
sums a process's blocks, then all-reduces across processes (NCCL between
cards, gloo on the CPU)::

    from se2lam_tpu_torch.parallel import runtime
    runtime.init_distributed(coordinator="host0:9999", num_processes=N,
                             process_id=i)
    mesh = runtime.global_mesh()
    ... dist_solve_pose_graph(prob, mesh) ...

Nothing is detected from the environment: the coordinator's address, the
world size and the rank are the caller's.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .mesh import Mesh

__all__ = ["init_distributed", "global_mesh", "is_initialized"]

_STATE: dict = {}


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_ids: list[int] | None = None, device=None,
                     blocks_per_device: int = 1) -> None:
    """Join this process to a ``torch.distributed`` group at
    ``tcp://coordinator`` (host:port of process 0). Its blocks: one per
    CUDA card in ``local_device_ids`` (all visible cards for None), or,
    with ``device``, ``blocks_per_device`` blocks on that device. The
    backend follows the devices: NCCL for CUDA, gloo for the CPU.
    Idempotent."""
    if _STATE:
        return
    import torch.distributed as dist

    if device is None:
        resolve_device(None)
        ids = (list(range(torch.cuda.device_count())) if local_device_ids is None
               else list(local_device_ids))
        devices = [torch.device("cuda", i) for i in ids]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devices = [dev] * blocks_per_device
    backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _STATE.update(devices=devices, n=num_processes, rank=process_id, backend=backend)


def is_initialized() -> bool:
    return bool(_STATE)


def global_mesh(axis: str = "d") -> Mesh:
    """The mesh over every process's blocks: this process's devices, its
    rank and the world group."""
    if not _STATE:
        raise RuntimeError("global_mesh: call init_distributed first")
    import torch.distributed as dist

    return Mesh(_STATE["devices"], axis, group=dist.group.WORLD, rank=_STATE["rank"],
                n_processes=_STATE["n"])


def backend() -> str | None:
    """The process group's backend ("nccl" or "gloo"), None before init."""
    return _STATE.get("backend")


def shutdown() -> None:
    """Leave the group (the next ``init_distributed`` joins anew)."""
    if _STATE:
        import torch.distributed as dist

        dist.destroy_process_group()
        _STATE.clear()
