"""Device-to-host copies started early (port of se2lam_tpu/utils/prefetch.py).

``host_prefetch(*tensors)`` starts the copy of each tensor into pinned host
memory with ``non_blocking=True`` on the current stream and records a CUDA
event behind the copies; ``HostCopy.get()`` waits on that event and returns
numpy arrays. The copy overlaps whatever the host queues meanwhile, so the
read that resolves a pipelined frame finds its bytes landed. On CPU tensors
nothing is copied early: ``get()`` reads them as they are. Either way the
values are the tensors' own.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["HostCopy", "host_prefetch"]


class HostCopy:
    """The pending host copies of some tensors; ``get()`` returns them."""

    def __init__(self, tensors):
        self._src = [t.detach() for t in tensors]
        self._dst = None
        self._event = None
        cuda = [t for t in self._src if t.device.type == "cuda"]
        if cuda:
            dst = []
            for t in self._src:
                if t.device.type == "cuda":
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    dst.append(h)
                else:
                    dst.append(t)
            self._dst = dst
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(cuda[0].device))

    def get(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
            return [t.numpy() for t in self._dst]
        return [t.numpy() for t in self._src]


def host_prefetch(*tensors) -> HostCopy:
    """Start the host copies of ``tensors`` now; read them with ``get()``."""
    return HostCopy(tensors)
