"""Synthetic data generation (port of se2lam_tpu.io.synthetic)."""
from .synthetic import SyntheticWorld  # noqa: F401
