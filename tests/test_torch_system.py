"""The slice as a whole: the port's synchronous ``SlamSystem`` (loops off)
against the JAX package's on the 40-frame lap of ``tests/test_system.py``
(320x240, 256 features, 2 levels), every tracked frame drawing its RANSAC
samples from the JAX package's per-frame Gumbel noise.

The last tests run ``SlamSystem(cfg)`` with its defaults (loops on) on
the revisit lap of ``tests/test_async_mapping.py``, and a 3-keyframe bank
through capacity relief (the JAX parity of both is in
``tests/test_torch_loopclose.py`` and ``tests/test_torch_capacity.py``).

Tolerances: the same keyframe frame ids (no slack was needed on this
lap); each package's ATE < 0.2 m (the JAX package's own bound,
``tests/test_system.py``); the two ATEs, live and re-anchored, within
0.02 m; keyframe poses within 1e-2 m (local BA's f32 solves differ in
summation order, ``tests/test_torch_localmap.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.io import SyntheticWorld, ate_se2 as jax_ate
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io.trajectory import ate_se2, load_trajectory
from se2lam_tpu_torch.system import SlamSystem

from test_torch_localmap import lap_cfg

torch.set_num_threads(2)
N_FRAMES = 40


@pytest.fixture(scope="module")
def both():
    cfg = lap_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    seq = list(world.sequence(N_FRAMES, noise=(0.004, 0.002, 0.002)))
    js = JaxSlam(cfg, enable_loops=False)
    key = jax.random.PRNGKey(0)     # SlamSystem's own key, split once per tracked frame
    noise = []
    for img, odo in seq:
        tracked = js.ts is not None
        js.process(img, odo)
        if tracked:
            key, sub = jax.random.split(key)
            g = jax.random.gumbel(sub, (cfg.cap.ransac_trials, cfg.cap.n_features), jnp.float32)
            noise.append(torch.from_numpy(np.array(g)))
        else:
            noise.append(None)
    ts = SlamSystem(config_from_fields(dataclasses.asdict(cfg)), enable_loops=False,
                    device="cpu")
    ts.log_ba = True
    for (img, odo), g in zip(seq, noise):
        ts.process(img, odo, gumbel=g)
    return js, ts, world.gt


def test_same_keyframes_as_jax(both):
    js, ts, _ = both
    assert ts.frame_id == N_FRAMES
    assert ts.kf_frame_ids == js.kf_frame_ids
    assert len(ts.kf_frame_ids) >= 5
    assert ts.n_keyframes() == js.n_keyframes()
    assert ts.n_local_ba == len(ts.kf_frame_ids) - 1 == len(ts.ba_log)
    assert abs(ts.n_map_points() - js.n_map_points()) <= 2


def test_ate_matches_jax(both):
    js, ts, gt = both
    live = {}
    for name, s in (("jax", js), ("port", ts)):
        est = np.asarray([p for _, p in s.trajectory])
        assert np.isfinite(est).all()
        live[name] = ate_se2(est[:, :2], gt[: len(est), :2])[0]
        assert live[name] < 0.2, (name, live[name])
    assert abs(live["jax"] - live["port"]) < 0.02, live
    cor_j = js.corrected_trajectory()[:, 1:3]
    cor_t = ts.corrected_trajectory()[:, 1:3]
    assert abs(ate_se2(cor_t, gt[: len(cor_t), :2])[0]
               - jax_ate(cor_j, gt[: len(cor_j), :2])[0]) < 0.02
    np.testing.assert_allclose(ts.kf_trajectory(), js.kf_trajectory(), rtol=0, atol=1e-2)


def test_every_local_ba_descends(both):
    _, ts, _ = both
    for rec in ts.ba_log:
        assert rec["chi2"] <= rec["chi2_init"], rec
        assert rec["iters"] == ts.cfg.local_iter


def test_trajectory_files(both, tmp_path):
    _, ts, _ = both
    ts.save_kf_trajectory(str(tmp_path / "kf.txt"))
    rows = load_trajectory(str(tmp_path / "kf.txt"))
    np.testing.assert_allclose(rows, ts.kf_trajectory(), atol=1e-6)
    ts.save_frame_trajectory(str(tmp_path / "frames.csv"))
    lines = (tmp_path / "frames.csv").read_text().splitlines()
    assert len(lines) == N_FRAMES and lines[0].startswith("0,")
    assert ts.current_pose().shape == (3,)


def test_default_system_closes_the_revisit_lap():
    """``SlamSystem(cfg)`` with its defaults (loops on, its own RANSAC
    draws) on the 126-frame revisit lap of ``tests/test_async_mapping.py``:
    a loop closes and the corrected trajectory beats raw odometry."""
    from test_dist_system import _world_cfg

    cfg = _world_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    lap = world.circle_trajectory(90)
    gt = np.concatenate([lap, lap])[:126]
    odo = world.odometry(gt, noise=(0.012, 0.006, 0.006), seed=3)
    s = SlamSystem(config_from_fields(dataclasses.asdict(cfg)), device="cpu")
    for g, o in zip(gt, odo):
        s.process(world.render(g), o)
    lc = s._loop_closer
    assert lc.n_loops_closed >= 1 and lc.last_loop is not None
    corr = s.corrected_trajectory()
    assert np.isfinite(corr).all()
    assert ate_se2(corr[:, 1:3], gt[:, :2])[0] < ate_se2(odo[:, :2], gt[:, :2])[0]


@pytest.mark.parametrize("feed", ["process_async", "process_chunk", "process_chunk_async"])
def test_feeds_of_later_slices_raise(feed):
    """The feeds of slice 5 run now and give ``process``'s poses on the
    lap's first 6 frames (the whole feeds are held in
    tests/test_torch_chunked.py); what still raises is the mesh."""
    cfg = config_from_fields(dataclasses.asdict(lap_cfg()))
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    seq = list(world.sequence(6, noise=(0.004, 0.002, 0.002)))
    ref, s = (SlamSystem(cfg, enable_loops=False, device="cpu") for _ in range(2))
    want = [ref.process(img, odo) for img, odo in seq]
    imgs, odos = [f[0] for f in seq], [f[1] for f in seq]
    if feed == "process_async":
        got = [s.process_async(img, odo) for img, odo in seq]
        got = [p for p in got if p is not None] + list(s.flush_async())
    elif feed == "process_chunk":
        got = list(s.process_chunk(imgs, odos))
    else:
        got = [p for r in (s.process_chunk_async(imgs[:1], odos[:1]),
                           s.process_chunk_async(imgs[1:], odos[1:]), s.flush_chunk_async())
               if r is not None for p in r]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(NotImplementedError, match="item 20"):
        SlamSystem(cfg, mesh=object(), device="cpu")


def test_capacity_pressure_compacts():
    """The 3-keyframe bank that used to raise: capacity relief prunes and
    compacts, and mapping goes on past the bank's size."""
    cfg = lap_cfg()
    cfg = cfg.replace(cap=dataclasses.replace(cfg.cap, max_kfs=3))
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    s = SlamSystem(config_from_fields(dataclasses.asdict(cfg)), enable_loops=False,
                   device="cpu", generator=torch.Generator().manual_seed(0))
    for img, odo in world.sequence(20, noise=(0.004, 0.002, 0.002)):
        s.process(img, odo)
    assert s.capacity_compactions >= 1
    assert s.n_keyframes() <= 3 and len(s.kf_frame_ids) == s.n_keyframes()
    assert max(s.kf_frame_ids) > 10
    assert np.isfinite(s.corrected_trajectory()).all()
