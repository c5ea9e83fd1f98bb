"""Geometry ops on batched tensors (port of se2lam_tpu.ops)."""
from . import camera, linalg, se2, se3, triangulate

__all__ = ["camera", "linalg", "se2", "se3", "triangulate"]
