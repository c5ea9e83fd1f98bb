"""The localization slice as a whole: the port's ``Localizer`` and
``SlamSystem.resume`` against the JAX package's on the CPU.

The map is built once by the JAX ``SlamSystem`` on the 320x240 fixture
of ``tests/test_localizer.py`` (60 frames) and saved with JAX's
``save_map`` (its 512-word vocabulary included); each package loads it
with its own ``load_map``, so the format is exercised on the way. Both
packages localize the same JAX-extracted features (carried across by
``convert.py``) on a second traversal with noisy odometry, and the port
replays the JAX package's RANSAC draws: the Localizer's ``PRNGKey(7)``
split per relocalization attempt, and ``SlamSystem``'s ``PRNGKey(0)``
split per tracked frame.

Tolerances: tracked flags, relocalization frames, candidate keyframes and
keyframe slots equal; poses within 1e-3, the JAX package's own tolerance
between its feeds (``se2lam_tpu/localizer.py:333-336``): the pose-only
solve sums in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.config import Capacity, SystemConfig
from se2lam_tpu.frontend.orb import OrbConfig, make_extractor
from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.io import load_map as jload
from se2lam_tpu.localizer import Localizer as JLoc
from se2lam_tpu.ops import se2 as jse2
from se2lam_tpu.system import SlamSystem as JSlam
from se2lam_tpu_torch.convert import config_from_fields, orb_features_from_numpy
from se2lam_tpu_torch.io import load_map as tload
from se2lam_tpu_torch.localizer import Localizer as TLoc
from se2lam_tpu_torch.system import SlamSystem as TSlam

from synth_utils import TCB

torch.set_num_threads(2)
START, N_LOC = 15, 20


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    oc = OrbConfig(height=240, width=320, n_features=256, scale_factor=1.2, n_levels=2)
    cfg = SystemConfig(
        width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        Tbc=tuple(np.linalg.inv(TCB).ravel()), upper_depth=30.0, lower_depth=0.2,
        max_feature_num=256, max_level=2,
        min_frames_between_kf=2, max_frames_between_kf=8, local_iter=6,
        cap=Capacity(n_features=oc.n_slots, max_kfs=64, max_mps=4096, local_kfs=8,
                     local_ref_kfs=8, local_mps=512, ransac_trials=64),
    )
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    slam = JSlam(cfg, enable_loops=False)
    for img, odo in world.sequence(60, noise=(0.001, 0.001, 0.0005)):
        slam.process(img, odo)
    path = str(tmp_path_factory.mktemp("map") / "saved")
    slam.save_map(path)

    gt = world.circle_trajectory(60)
    gt_map = np.asarray([np.asarray(jse2.minus(jnp.asarray(g), jnp.asarray(gt[0]))) for g in gt])
    odo = world.odometry(gt, noise=(0.002, 0.001, 0.001), seed=9).astype(np.float32)
    extract = jax.jit(make_extractor(oc))
    feats = {i: extract(jnp.asarray(world.render(gt[i]))) for i in range(START, START + N_LOC + 1)}
    return dict(cfg=cfg, tcfg=config_from_fields(dataclasses.asdict(cfg)), path=path,
                gt_map=gt_map, odo=odo, feats=feats, n_kf=slam.n_keyframes())


def jax_reloc_noise(n_trials, n_slots, seed=7):
    """The JAX Localizer's draws: split its key once per attempt."""
    key = [jax.random.PRNGKey(seed)]

    def nxt():
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, (n_trials, n_slots), jnp.float32)))
    return nxt


def _port_feats(f):
    return orb_features_from_numpy(jax.tree.map(np.asarray, f), device="cpu")


def _record_attempts(loc, log):
    """Log (frame, candidate keyframe, verified) per relocalization attempt."""
    orig = loc._relocalize_at

    def wrapped(cand, feats):
        out = orig(cand, feats)
        log.append((loc.frame_id, int(cand), out is not None))
        return out
    loc._relocalize_at = wrapped


def _pair(fx, **kw):
    jms, jvocab, _ = jload(fx["path"])
    tms, tvocab, _ = tload(fx["path"], device="cpu")
    jl = JLoc(fx["cfg"], jms, jvocab, **kw)
    tl = TLoc(fx["tcfg"], tms, tvocab, device="cpu", **kw)
    tl.reloc_gumbel = jax_reloc_noise(fx["cfg"].cap.ransac_trials, fx["cfg"].cap.n_features)
    return jl, tl


def _run(fx, jl, tl, frames):
    logs = ([], [])
    _record_attempts(jl, logs[0])
    _record_attempts(tl, logs[1])
    for i in frames:
        jl.process_features(fx["feats"][i], fx["odo"][i])
        tl.process_features(_port_feats(fx["feats"][i]), fx["odo"][i])
    assert [t for _, _, t in tl.trajectory] == [t for _, _, t in jl.trajectory]
    for (_, pt, _), (_, pj, _) in zip(tl.trajectory, jl.trajectory):
        assert (pt is None) == (pj is None)
        if pt is not None:
            np.testing.assert_allclose(pt, np.asarray(pj), rtol=0, atol=1e-3)
    return logs


def test_tracked_path_matches_jax(fixture):
    fx = fixture
    jl, tl = _pair(fx, reloc_min_inliers=30)
    for loc in (jl, tl):
        loc.set_pose(fx["gt_map"][START], fx["odo"][START])
    logs = _run(fx, jl, tl, range(START + 1, START + N_LOC + 1))
    assert logs[0] == logs[1]
    tracked = [t for _, _, t in tl.trajectory]
    assert sum(tracked) >= N_LOC - 2, tracked
    est = np.asarray([p for _, p, _ in tl.trajectory if p is not None])
    gt = fx["gt_map"][START + 1: START + N_LOC + 1][[p is not None for _, p, _ in tl.trajectory]]
    assert np.median(np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)) < 0.3


def test_cold_start_relocalizes_like_jax(fixture):
    fx = fixture
    jl, tl = _pair(fx, reloc_min_inliers=30)
    logs = _run(fx, jl, tl, range(START, START + 10))
    assert logs[0] == logs[1]                      # same frames, candidates, outcomes
    first = [(f, c) for f, c, ok in logs[1] if ok]
    assert first and first[0][0] <= 3, logs[1]      # within the first 4 frames
    assert sum(t for _, p, t in tl.trajectory if p is not None) >= 5


def test_localizer_trajectory_and_unported_feeds(fixture, tmp_path):
    """The trajectory file; and the feeds that were not ported before
    slice 5 now run: the pipelined feed on features gives the per-frame
    trajectory (the chunked feed is held in tests/test_torch_fleet_localize.py)."""
    fx = fixture
    _, tl = _pair(fx, reloc_min_inliers=30)
    for i in range(START, START + 3):
        tl.process_features(_port_feats(fx["feats"][i]), fx["odo"][i])
    tl.save_trajectory(str(tmp_path / "loc.csv"))
    lines = (tmp_path / "loc.csv").read_text().splitlines()
    assert len(lines) == 3 and lines[0].startswith("0,")
    _, pl = _pair(fx, reloc_min_inliers=30)
    pl.pipeline_depth = 2
    for i in range(START, START + 3):
        pl.process_features_async(_port_feats(fx["feats"][i]), fx["odo"][i])
    pl.flush_async()
    assert [(t, None if p is None else tuple(p)) for _, p, t in pl.trajectory] == [
        (t, None if p is None else tuple(p)) for _, p, t in tl.trajectory]
    assert pl.process_chunk([], []) == [] and pl.flush_async() == []


def test_resume_matches_jax(fixture):
    fx = fixture
    js = JSlam.resume(fx["cfg"], fx["path"], enable_loops=False)
    ts = TSlam.resume(fx["tcfg"], fx["path"], enable_loops=False, device="cpu")
    ts._reloc_localizer.reloc_gumbel = jax_reloc_noise(fx["cfg"].cap.ransac_trials,
                                                       fx["cfg"].cap.n_features)
    assert ts.kf_frame_ids == js.kf_frame_ids == [-1] * fx["n_kf"]
    key = jax.random.PRNGKey(0)          # SlamSystem's own key, split per tracked frame
    T, N = fx["cfg"].cap.ransac_trials, fx["cfg"].cap.n_features
    for i in range(START, START + 8):
        tracked = js.ts is not None
        pj = js.process_features(fx["feats"][i], fx["odo"][i])
        g = None
        if tracked:
            key, sub = jax.random.split(key)
            g = torch.from_numpy(np.array(jax.random.gumbel(sub, (T, N), jnp.float32)))
        pt = ts.process_features(_port_feats(fx["feats"][i]), fx["odo"][i], gumbel=g)
        np.testing.assert_allclose(pt, np.asarray(pj), rtol=0, atol=1e-3)
    # relocalized on the same frame, the seed keyframe at the same slot
    assert ts.kf_frame_ids == js.kf_frame_ids
    assert len(ts.kf_frame_ids) > fx["n_kf"] and ts.kf_frame_ids[fx["n_kf"]] >= 0
    assert ts.n_keyframes() == js.n_keyframes()
    np.testing.assert_allclose(ts.kf_trajectory(), js.kf_trajectory(), rtol=0, atol=1e-3)
    assert ts._reloc_localizer is None


def test_port_save_map_resumes_in_jax(fixture, tmp_path):
    """A map saved by the port's ``SlamSystem.save_map`` (vocabulary
    trained by the port) resumes in the JAX package; with loops on (the
    default) ``resume`` adopts the loaded vocabulary and banks every
    loaded keyframe."""
    fx = fixture
    ts = TSlam.resume(fx["tcfg"], fx["path"], enable_loops=False, device="cpu")
    ts.save_map(str(tmp_path / "port_map"))
    jms, jvocab, info = jload(str(tmp_path / "port_map"))
    assert jvocab is not None and jvocab.words.shape == (512, 256)
    assert info["n_kf"] == fx["n_kf"]
    assert (tmp_path / "port_map" / "se2lam_kf_trajectory.txt").is_file()
    js = JSlam.resume(fx["cfg"], str(tmp_path / "port_map"), enable_loops=False)
    poses = [js.process_features(fx["feats"][i], fx["odo"][i]) for i in range(START, START + 4)]
    assert any(np.linalg.norm(p) > 1e-6 for p in poses), "no relocalization"
    tl = TSlam.resume(fx["tcfg"], fx["path"], device="cpu")._loop_closer
    _, tvocab, _ = tload(fx["path"], device="cpu")
    assert torch.equal(tl.vocab.words, tvocab.words) and torch.equal(tl.vocab.idf, tvocab.idf)
    valid = np.arange(tl.bank.shape[0]) < fx["n_kf"]
    bank = tl.bank.numpy()
    assert np.any(bank[valid] != 0, axis=1).all() and not np.any(bank[~valid] != 0)
