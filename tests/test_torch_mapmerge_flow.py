"""Map merging in the port alone, on the CPU, over the flows of
``tests/test_mapmerge.py`` (its ``_cfg``: 160x120, 128 features, 2 levels;
``SyntheticWorld(n_landmarks=400, room=10.0, seed=2)``, exact odometry):
``merge_many`` over three robots' segments, ``SlamSystem.resume`` on a
saved merged map, and maps built with loops on (every feature edge carried
over, covisibility across the seam). The bounds are the JAX tests'.
"""
import dataclasses

import numpy as np
import pytest
import torch

from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io import SyntheticWorld, save_map
from se2lam_tpu_torch.mapmerge import merge_maps, merge_many
from se2lam_tpu_torch.mapstate import MAX_FTR_EDGES
from se2lam_tpu_torch.system import SlamSystem

from test_mapmerge import _cfg
from test_prune import check_consistency

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cfg():
    return config_from_fields(dataclasses.asdict(_cfg()))


def _circle(cfg, n):
    """The JAX tests' world and an n-frame circle, rendered."""
    world = SyntheticWorld(cfg, n_landmarks=400, room=10.0, seed=2)
    gt = np.asarray(world.circle_trajectory(n))
    return cfg, gt, [world.render(g) for g in gt]


@pytest.fixture(scope="module")
def scene(cfg):
    return _circle(cfg, 80)


def _build(scene, frames, enable_loops=False):
    cfg, gt, imgs = scene
    slam = SlamSystem(cfg, enable_loops=enable_loops, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for i in frames:
        slam.process(imgs[i], np.asarray(gt[i], np.float32))
    return slam


def test_merge_many_three_segments(cfg):
    scene = _circle(cfg, 90)
    segs = [range(0, 40), range(30, 70), range(60, 90)]
    maps = [_build(scene, s).ms for s in segs]
    merged, infos = merge_many(maps, cfg, device="cpu")
    assert len(infos) == 2
    assert "vocab" in infos[-1] and "vocab" not in infos[0]
    check_consistency(merged)
    assert int(merged.n_kf) == sum(int(m.kf_valid.sum()) for m in maps)
    assert all(i["mps_fused"] >= 1 for i in infos)


def test_resume_on_merged_map(scene, tmp_path):
    """A merged map is a map like any other: saved with its union
    vocabulary, a resumed session relocalizes on it and keeps mapping
    across the seam."""
    cfg, gt, imgs = scene
    slam_a = _build(scene, range(0, 48))
    slam_b = _build(scene, range(40, 80))
    merged, info = merge_maps(slam_a.ms, slam_b.ms, cfg, device="cpu")
    path = str(tmp_path / "merged")
    save_map(path, merged, info["vocab"])
    slam = SlamSystem.resume(cfg, path, enable_loops=False, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    kf0 = slam.n_keyframes()
    for f in range(60, 80):
        assert np.isfinite(slam.process(imgs[f], np.asarray(gt[f], np.float32))).all()
    assert not slam._resume_pending, "resume never relocalized"
    assert slam.n_keyframes() > kf0, "no new keyframes landed on the merged map"
    check_consistency(slam.ms)


def test_merge_with_loops_enabled_and_seam_covis(scene):
    cfg = scene[0]
    ms_a = _build(scene, range(0, 48), enable_loops=True).ms
    ms_b = _build(scene, range(40, 80), enable_loops=True).ms
    fa, fb = int(ms_a.ftr_valid.sum()), int(ms_b.ftr_valid.sum())
    assert fa + fb + 1 <= MAX_FTR_EDGES, "scenario outgrew the edge table"
    merged, _ = merge_maps(ms_a, ms_b, cfg, device="cpu")
    check_consistency(merged)
    # every edge survived, plus the seam's (no eviction was needed)
    assert int(merged.ftr_valid.sum()) == fa + fb + 1
    na = int(ms_a.kf_valid.sum())
    assert merged.covis[:na, na:].any(), "no cross-map covisibility after fusion"
