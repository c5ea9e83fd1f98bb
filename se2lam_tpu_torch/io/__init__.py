"""Synthetic data and trajectory IO (port of se2lam_tpu.io's synthetic
world and trajectory files)."""
from .synthetic import SyntheticWorld  # noqa: F401
from .trajectory import ate_se2, load_trajectory, save_trajectory  # noqa: F401
