"""Synthetic data, trajectory IO and map storage (port of se2lam_tpu.io's
synthetic world, trajectory files and map checkpoints)."""
from .mapstorage import load_map, save_map  # noqa: F401
from .synthetic import SyntheticWorld  # noqa: F401
from .trajectory import ate_se2, load_trajectory, save_trajectory  # noqa: F401
