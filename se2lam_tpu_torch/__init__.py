"""PyTorch/CUDA port of se2lam_tpu, the SE(2)-constrained visual-odometric
SLAM engine, for one NVIDIA Hopper GPU.

The package mirrors ``se2lam_tpu``'s layout (``config``, ``ops``,
``frontend``, ``factors``, ``tracking``, ``io``) so each module has a
counterpart of the same name. It imports torch and numpy only: no JAX and
nothing of ``se2lam_tpu``, whose numpy tables it keeps its own copies of.

Entry points take ``device=None``, which means the GPU; they raise when
there is none instead of running on the CPU. The CPU is used only where a
caller asks for it (``device="cpu"``), as the tests do.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
