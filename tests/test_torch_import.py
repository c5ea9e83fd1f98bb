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
import se2lam_tpu_torch.io, se2lam_tpu_torch.kernels, se2lam_tpu_torch.kernels.samples
import se2lam_tpu_torch.ops
import se2lam_tpu_torch.tracking
import se2lam_tpu_torch.mapstate, se2lam_tpu_torch.localmap, se2lam_tpu_torch.system
import se2lam_tpu_torch.solver.ba, se2lam_tpu_torch.solver.schur, se2lam_tpu_torch.ops.topk
import se2lam_tpu_torch.io.trajectory, se2lam_tpu_torch.io.mapstorage
import se2lam_tpu_torch.vocab, se2lam_tpu_torch.solver.poseonly, se2lam_tpu_torch.loopclose
import se2lam_tpu_torch.frontend.windowed_match, se2lam_tpu_torch.localizer
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


def _empty_map():
    from se2lam_tpu_torch.config import Capacity
    from se2lam_tpu_torch.mapstate import empty_map
    empty_map(Capacity(max_kfs=4, max_mps=16, n_features=8))


def _slam_system():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.system import SlamSystem
    SlamSystem(default_cfg()[0], enable_loops=False)


def _map_and_vocab():
    from se2lam_tpu_torch.config import Capacity
    from se2lam_tpu_torch.mapstate import empty_map
    from se2lam_tpu_torch.vocab import Vocabulary
    ms = empty_map(Capacity(max_kfs=4, max_mps=16, n_features=8), device="cpu")
    return ms, Vocabulary(torch.ones((4, 256), dtype=torch.int8), torch.ones(4))


def _localizer():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.localizer import Localizer
    Localizer(default_cfg()[0], *_map_and_vocab())


def _load_map():
    import tempfile

    from se2lam_tpu_torch.io import load_map, save_map
    with tempfile.TemporaryDirectory() as d:
        save_map(d, *_map_and_vocab())
        load_map(d)


@pytest.mark.parametrize("make", [_entry, _extractor, _camera, _convert, _empty_map,
                                  _slam_system, _localizer, _load_map],
                         ids=["entry", "extractor", "camera", "convert", "empty_map",
                              "slam_system", "localizer", "load_map"])
def test_device_none_means_cuda_and_raises_without_it(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        make()
