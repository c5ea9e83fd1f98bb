"""Build and load the port's hand-written CUDA kernels (``csrc/``)."""
from .build import build_all, load_library

__all__ = ["build_all", "load_library"]
