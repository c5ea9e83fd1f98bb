"""The port's chunked feeds through loop closing and capacity relief.

- Loops on, the revisit lap of ``tests/test_chunked.py::
  test_chunked_closes_loops_too`` (a 48-frame lap plus 28 revisit frames,
  320x240; tracking's generator seeded 1, with which the port closes a
  loop at frame 52): ``process_chunk`` (chunks of 8) against ``process``.
  The closure lands inside a keyframe insertion in the middle of a chunk;
  the frames after it must be tracked from the re-based state, and the
  loop closer's own generator drawn in the same order.
- The port's ``process_chunk`` against the JAX package's on the 33 uint8
  frames of ``tests/test_torch_chunked.py`` (chunks of 8), the port drawing
  JAX's per-frame noise: keyframe frames equal, poses and keyframe poses
  within 1e-2 m, as ``tests/test_torch_system.py`` holds its lap.
- Capacity pressure, the 8-keyframe bank of ``tests/test_capacity.py:95``
  (160x120, 40 frames in chunks of 8): relief compacts the keyframe slots
  while a chunk is in flight; the chunked feed against ``process``, and
  the map's tables consistent at the end.

Tolerance, port against port: bitwise (keyframe frames, closures,
compactions, every live and corrected pose): the feeds run the same eager
ops on the same inputs.
"""
import dataclasses

import numpy as np
import torch

from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.system import SlamSystem

from test_capacity import _cfg as capacity_cfg
from test_chunked import _cfg
from test_prune import check_consistency
from test_torch_chunked import N_FRAMES, jax_track_noise, lap, port_slam  # noqa: F401

torch.set_num_threads(2)


def _slam(cfg, seed=0, **kw):
    return SlamSystem(config_from_fields(dataclasses.asdict(cfg)), device="cpu",
                      generator=torch.Generator().manual_seed(seed), **kw)


def _poses(s):
    return np.asarray([p for _, p in s.trajectory], np.float32)


def _assert_same(s, ref):
    assert s.frame_id == ref.frame_id
    assert s.kf_frame_ids == ref.kf_frame_ids
    np.testing.assert_array_equal(_poses(s), _poses(ref))
    np.testing.assert_array_equal(s.corrected_trajectory(), ref.corrected_trajectory())
    assert torch.equal(s.ms.kf_pose, ref.ms.kf_pose)


def test_chunked_feeds_close_loops_as_process():
    cfg = _cfg().replace(gm_dcl_min_kfid_offset=8, gm_vcl_num_min_match_mp=5,
                         gm_vcl_num_min_match_kp=15)
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    lap = world.circle_trajectory(48)
    gt = np.concatenate([lap, lap[:28]])
    odo = world.odometry(gt, noise=(0.004, 0.002, 0.002), seed=3)
    imgs = [world.render(g) for g in gt]

    ref = _slam(cfg, seed=1)
    for img, o in zip(imgs, odo):
        ref.process(img, o)
    chk = _slam(cfg, seed=1)
    for i in range(0, len(gt), 8):
        chk.process_chunk(imgs[i:i + 8], odo[i:i + 8])

    assert ref._loop_closer.n_loops_closed >= 1
    assert chk._loop_closer.n_loops_closed == ref._loop_closer.n_loops_closed
    assert chk._loop_closer.last_loop == ref._loop_closer.last_loop
    _assert_same(chk, ref)


def test_capacity_pressure_chunked_feed():
    cfg = capacity_cfg()
    world = SyntheticWorld(cfg, n_landmarks=300, room=10.0, seed=1)
    frames = list(world.sequence(40, noise=(0.002, 0.001, 0.001)))
    ref = _slam(cfg, enable_loops=False)
    for img, o in frames:
        ref.process(img, o)
    s = _slam(cfg, enable_loops=False)
    for i in range(0, 40, 8):
        b = frames[i:i + 8]
        assert np.isfinite(s.process_chunk([f[0] for f in b], [f[1] for f in b])).all()
    assert s.capacity_compactions == ref.capacity_compactions >= 1
    assert s.anchors_reanchored == ref.anchors_reanchored
    assert s.n_keyframes() <= cfg.cap.max_kfs
    _assert_same(s, ref)
    check_consistency(s.ms)


def test_process_chunk_matches_jax(lap):
    """Both packages' process_chunk on the same uint8 frames (chunks of 8),
    the port drawing JAX's per-frame noise."""
    cfg, frames, _ = lap
    js = JaxSlam(cfg, enable_loops=False)
    ts = port_slam(cfg)
    ts.track_noise = jax_track_noise(cfg)
    for i in range(0, N_FRAMES, 8):
        imgs, odos = [f[0] for f in frames[i:i + 8]], [f[1] for f in frames[i:i + 8]]
        js.process_chunk(imgs, odos)
        ts.process_chunk(imgs, odos)
    assert ts.kf_frame_ids == js.kf_frame_ids
    np.testing.assert_allclose(ts.kf_trajectory(), js.kf_trajectory(), rtol=0, atol=1e-2)
    np.testing.assert_allclose(_poses(ts), np.asarray([p for _, p in js.trajectory]),
                               rtol=0, atol=1e-2)
