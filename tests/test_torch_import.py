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
import se2lam_tpu_torch.ops.fixed_order
import se2lam_tpu_torch.io.trajectory, se2lam_tpu_torch.io.mapstorage
import se2lam_tpu_torch.vocab, se2lam_tpu_torch.solver.poseonly, se2lam_tpu_torch.loopclose
import se2lam_tpu_torch.frontend.windowed_match, se2lam_tpu_torch.localizer
import se2lam_tpu_torch.solver.posegraph
import se2lam_tpu_torch.solver, se2lam_tpu_torch.solver.sparsifier, se2lam_tpu_torch.frontend.fast
import se2lam_tpu_torch.utils, se2lam_tpu_torch.utils.chunking, se2lam_tpu_torch.utils.prefetch
import se2lam_tpu_torch.parallel, se2lam_tpu_torch.parallel.fleet
import se2lam_tpu_torch.parallel.fleet_localize
import se2lam_tpu_torch.parallel.mesh, se2lam_tpu_torch.parallel.runtime
import se2lam_tpu_torch.parallel.dist_ba, se2lam_tpu_torch.parallel.dist_posegraph
import se2lam_tpu_torch.parallel.dist_loop
from se2lam_tpu_torch.entry import dryrun_multichip
import se2lam_tpu_torch.mapmerge, se2lam_tpu_torch.viz, se2lam_tpu_torch.utils.timing
import se2lam_tpu_torch.io.dataset, se2lam_tpu_torch.io.native_loader
import se2lam_tpu_torch.io.liveserver
import se2lam_tpu_torch.drivers, se2lam_tpu_torch.drivers.run_dataset
import se2lam_tpu_torch.drivers.run_localization, se2lam_tpu_torch.drivers.merge_maps
import se2lam_tpu_torch.drivers.make_dataset, se2lam_tpu_torch.drivers.serve_live
import se2lam_tpu_torch.drivers.feed_live, se2lam_tpu_torch.drivers.fleet_demo
import se2lam_tpu_torch.drivers.evaluate_ate
for name in se2lam_tpu_torch._LAZY:
    getattr(se2lam_tpu_torch, name)
for name in ("receive_odo", "receive_img", "_maybe_step", "receive_odo_data", "receive_img_data",
             "get_current_vehicle_pose", "request_finish", "wait_for_finish"):
    getattr(se2lam_tpu_torch.system.SlamSystem, name)     # the OdoSLAM surface
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


_LAZY_PROBE = """
import sys
import se2lam_tpu_torch
cheap = not any(m in sys.modules for m in ("se2lam_tpu_torch.system", "se2lam_tpu_torch.mapmerge",
                                           "se2lam_tpu_torch.frontend.orb"))
from se2lam_tpu_torch.mapmerge import merge_maps
from se2lam_tpu_torch.system import SlamSystem
print("LAZY", cheap, se2lam_tpu_torch.SlamSystem is SlamSystem,
      se2lam_tpu_torch.merge_maps is merge_maps, sorted(se2lam_tpu_torch._LAZY) == sorted(
          set(se2lam_tpu_torch.__all__) - {"resolve_device"}))
"""


def test_package_root_exports_lazily():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _LAZY_PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LAZY True True True True" in out.stdout, out.stdout
    import se2lam_tpu_torch
    with pytest.raises(AttributeError):
        se2lam_tpu_torch.no_such_name


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


def _default_slam_system():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.system import SlamSystem
    SlamSystem(default_cfg()[0])


def _loop_closer():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.loopclose import LoopCloser
    LoopCloser(default_cfg()[0])


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


def _batch_extractor():
    from se2lam_tpu_torch.frontend.orb import OrbConfig, make_batch_extractor
    make_batch_extractor(OrbConfig(height=64, width=64))


def _fleet_tracker():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.parallel import make_fleet_tracker
    make_fleet_tracker(default_cfg()[0])


def _fleet_localizer():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.parallel import make_fleet_localizer
    make_fleet_localizer(default_cfg()[0], _map_and_vocab()[0])


def _merge_maps():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.mapmerge import merge_maps
    ms = _map_and_vocab()[0]
    merge_maps(ms, ms, default_cfg()[0])


def _merge_many():
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.mapmerge import merge_many
    ms = _map_and_vocab()[0]
    merge_many([ms, ms], default_cfg()[0])


def _measure_rtt():
    from se2lam_tpu_torch.utils.timing import measure_rtt
    measure_rtt()


def _run_dataset_driver():
    import tempfile

    from se2lam_tpu_torch.drivers import run_dataset
    with tempfile.TemporaryDirectory() as d:
        run_dataset.main(["--synthetic", "--frames", "1", "--out", d])


def _make_mesh():
    from se2lam_tpu_torch.parallel import make_mesh
    make_mesh(2)


def _dryrun_multichip():
    from se2lam_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2)


def _init_distributed():
    from se2lam_tpu_torch.parallel import runtime
    runtime.init_distributed("127.0.0.1:1", 1, 0)


def _serve_live_driver():
    from se2lam_tpu_torch.drivers.serve_live import make_system
    from se2lam_tpu_torch.entry import default_cfg
    make_system(default_cfg()[0])


@pytest.mark.parametrize("make", [_entry, _extractor, _camera, _convert, _empty_map,
                                  _slam_system, _default_slam_system, _loop_closer,
                                  _localizer, _load_map, _batch_extractor, _fleet_tracker,
                                  _fleet_localizer, _merge_maps, _merge_many, _measure_rtt,
                                  _run_dataset_driver, _serve_live_driver, _make_mesh,
                                  _dryrun_multichip, _init_distributed],
                         ids=["entry", "extractor", "camera", "convert", "empty_map",
                              "slam_system", "default_slam_system", "loop_closer",
                              "localizer", "load_map", "batch_extractor", "fleet_tracker",
                              "fleet_localizer", "merge_maps", "merge_many", "measure_rtt",
                              "run_dataset_driver", "serve_live_driver", "make_mesh",
                              "dryrun_multichip", "init_distributed"])
def test_device_none_means_cuda_and_raises_without_it(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        make()
