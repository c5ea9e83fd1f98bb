"""ORB extraction, matching and RANSAC (port of se2lam_tpu.frontend)."""
from .matcher import (  # noqa: F401
    TH_HIGH,
    TH_LOW,
    hamming_matrix,
    match_by_window,
    mutual_match,
)
from .orb import OrbConfig, OrbExtractor, OrbFeatures  # noqa: F401
from .windowed_match import match_by_projection_streamed  # noqa: F401
