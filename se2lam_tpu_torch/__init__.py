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

__all__ = ["resolve_device", "SlamSystem", "Localizer", "SystemConfig", "Capacity",
           "MapState", "empty_map", "LoopCloser", "merge_maps"]

# lazy top-level exports, as the JAX package's root has them: importing the
# package stays cheap (no extractor, kernel or solver module is loaded)
# until a name is used
_LAZY = {
    "SlamSystem": ("se2lam_tpu_torch.system", "SlamSystem"),
    "Localizer": ("se2lam_tpu_torch.localizer", "Localizer"),
    "SystemConfig": ("se2lam_tpu_torch.config", "SystemConfig"),
    "Capacity": ("se2lam_tpu_torch.config", "Capacity"),
    "MapState": ("se2lam_tpu_torch.mapstate", "MapState"),
    "empty_map": ("se2lam_tpu_torch.mapstate", "empty_map"),
    "LoopCloser": ("se2lam_tpu_torch.loopclose", "LoopCloser"),
    "merge_maps": ("se2lam_tpu_torch.mapmerge", "merge_maps"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'se2lam_tpu_torch' has no attribute {name!r}")
