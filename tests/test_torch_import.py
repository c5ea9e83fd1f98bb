"""The port stands alone: importing it (and chip_smoke.py) loads no JAX and
nothing of the JAX package, and its entry points refuse to run on the CPU
unless the caller names the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
before = set(sys.modules)
import chip_smoke
import se2lam_tpu_torch
import se2lam_tpu_torch.convert, se2lam_tpu_torch.entry, se2lam_tpu_torch.factors
import se2lam_tpu_torch.frontend, se2lam_tpu_torch.frontend.ransac
import se2lam_tpu_torch.io, se2lam_tpu_torch.kernels, se2lam_tpu_torch.ops
import se2lam_tpu_torch.tracking
new = set(sys.modules) - before
bad = sorted(m for m in new
             if m.split(".")[0] in ("jax", "jaxlib")
             or (m.split(".")[0].startswith("se2lam_tpu")
                 and m.split(".")[0] != "se2lam_tpu_torch"))
print("BAD", bad)
"""


def test_import_loads_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _entry():
    from se2lam_tpu_torch.entry import entry
    entry()


def _extractor():
    from se2lam_tpu_torch.frontend.orb import OrbConfig, OrbExtractor
    OrbExtractor(OrbConfig(height=64, width=64))


def _camera():
    from se2lam_tpu_torch.ops.camera import CameraModel
    CameraModel.create(100.0, 100.0, 32.0, 32.0)


def _convert():
    from se2lam_tpu_torch.convert import orb_features_from_numpy
    from se2lam_tpu_torch.frontend.orb import OrbFeatures
    orb_features_from_numpy(OrbFeatures(*[np.zeros(1, np.float32)] * 7))


@pytest.mark.parametrize("make", [_entry, _extractor, _camera, _convert],
                         ids=["entry", "extractor", "camera", "convert"])
def test_device_none_means_cuda_and_raises_without_it(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        make()
