"""The port's SlamSystem on a device mesh: the counterpart of
``tests/test_dist_system.py`` on its 320x240, 256-feature revisit lap
(``_world_cfg``), the mesh being 8 blocks of the CPU.

On the mesh the loop closer scores a bank split over the blocks, GlobalBA
is the edge-sharded PCG and the joint GBA the map-block partitioned
Schur-GN, run staged (``LoopCloser.start_async``/``advance``).

- The mesh session closes a loop, beats raw odometry, and lands within
  0.02 m of ATE of the port's single-device session (parity is ATE-bound:
  the PCG and the re-bucketed accumulation sum in other orders).
- The pipelined feed on the mesh (the stage's values ride the resolved
  frames' reads, a closure re-bases the gauge and replays the frames in
  flight) gives the per-frame feed's keyframes and loop count, and its
  trajectory within 1e-5 (``tests/test_dist_system.py``).
- The chunked feed with ``async_mapping=False`` (the staged stage run to
  completion inside the insertion) closes a loop and beats odometry.
- The chunk pipeline on the mesh (``process_chunk_async``) gives the
  chunked feed's keyframes and poses over the lap's first 56 frames.
"""
import dataclasses

import numpy as np
import torch

from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.entry import session_cfg
from se2lam_tpu_torch.io.trajectory import ate_se2
from se2lam_tpu_torch.parallel import make_mesh
from se2lam_tpu_torch.parallel.dist_loop import ShardedRows
from se2lam_tpu_torch.system import SlamSystem

from test_dist_system import _world_cfg

torch.set_num_threads(2)


def _scene(n):
    cfg = _world_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    lap = world.circle_trajectory(90)
    gt = np.concatenate([lap, lap])[:n]
    odo = world.odometry(gt, noise=(0.012, 0.006, 0.006), seed=3)
    return config_from_fields(dataclasses.asdict(cfg)), gt, odo, [world.render(g) for g in gt]


def _ate(slam, gt):
    corr = slam.corrected_trajectory()[:, 1:]
    assert np.isfinite(corr).all()
    return float(ate_se2(corr[:, :2], gt[: len(corr), :2])[0])


def test_session_cfg_is_the_jax_world_cfg():
    assert session_cfg() == config_from_fields(dataclasses.asdict(_world_cfg()))


def test_mesh_system_matches_single_device():
    cfg, gt, odo, frames = _scene(126)
    ate_odo = float(ate_se2(odo[:, :2], gt[:, :2])[0])
    runs = {}
    for name, mesh in (("single", None), ("mesh", make_mesh(8, device="cpu"))):
        s = SlamSystem(cfg, mesh=mesh, device="cpu")
        for f, o in zip(frames, odo):
            s.process(f, o)
        runs[name] = (s, _ate(s, gt))
    (s1, ate_1), (s8, ate_8) = runs["single"], runs["mesh"]
    lc1, lc8 = s1._loop_closer, s8._loop_closer
    assert not lc1._dist and lc8._dist
    assert lc1.n_loops_closed >= 1 and lc8.n_loops_closed >= 1
    # the bank really is split over the 8 blocks
    assert isinstance(lc8.bank, ShardedRows) and len(lc8.bank.blocks) == 8
    assert ate_1 < ate_odo and ate_8 < ate_odo, (ate_1, ate_8, ate_odo)
    assert abs(ate_8 - ate_1) < 0.02, (ate_1, ate_8)


def test_mesh_pipelined_feed_matches_per_frame():
    cfg, gt, odo, frames = _scene(110)
    mesh = make_mesh(8, device="cpu")
    ref = SlamSystem(cfg, mesh=mesh, device="cpu")
    for f, o in zip(frames, odo):
        ref.process(f, o)
    pip = SlamSystem(cfg, mesh=mesh, device="cpu")
    pip.pipeline_depth = 3
    for f, o in zip(frames, odo):
        pip.process_async(f, o)
    pip.flush_async()
    assert ref._loop_closer.n_loops_closed >= 1
    assert pip._loop_closer.n_loops_closed == ref._loop_closer.n_loops_closed
    assert pip.kf_frame_ids == ref.kf_frame_ids
    np.testing.assert_allclose(np.asarray([p for _, p in pip.trajectory], np.float32),
                               np.asarray([p for _, p in ref.trajectory], np.float32),
                               atol=1e-5)


def test_mesh_chunked_feed_synchronous_stage():
    cfg, gt, odo, frames = _scene(126)
    s = SlamSystem(cfg, mesh=make_mesh(8, device="cpu"), async_mapping=False, device="cpu")
    for i in range(0, len(frames), 8):
        s.process_chunk(frames[i:i + 8], odo[i:i + 8])
    assert s._loop_pending is None
    assert s._loop_closer.n_loops_closed >= 1
    assert _ate(s, gt) < float(ate_se2(odo[:, :2], gt[:, :2])[0])


def test_mesh_chunk_pipeline_matches_chunked_feed():
    cfg, gt, odo, frames = _scene(56)
    mesh = make_mesh(4, device="cpu")
    ref = SlamSystem(cfg, mesh=mesh, device="cpu")
    for i in range(0, len(frames), 8):
        ref.process_chunk(frames[i:i + 8], odo[i:i + 8])
    pip = SlamSystem(cfg, mesh=mesh, device="cpu")
    for i in range(0, len(frames), 8):
        pip.process_chunk_async(frames[i:i + 8], odo[i:i + 8])
    pip.flush_chunk_async()
    assert len(ref.kf_frame_ids) >= 5 and pip.kf_frame_ids == ref.kf_frame_ids
    np.testing.assert_allclose(np.asarray([p for _, p in pip.trajectory], np.float32),
                               np.asarray([p for _, p in ref.trajectory], np.float32),
                               atol=1e-5)
    np.testing.assert_allclose(pip.corrected_trajectory(), ref.corrected_trajectory(), atol=1e-5)
