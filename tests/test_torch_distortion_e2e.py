"""The port's ``SlamSystem`` under lens distortion, and resumed with loops
on, against the JAX package's, as ``tests/test_distortion_e2e.py`` runs
them (the 320x240, 256-feature scene of ``SyntheticWorld(n_landmarks=600,
room=10.0, seed=4)``).

Both packages see the same frames, and the port replays the JAX
package's draws (``jax_draws``): tracking's per-frame RANSAC noise, the
resumed session's relocalization noise and, with loops on, each loop
stage's per-candidate noise from the key JAX handed that stage. The
resumed session starts from one map, built and saved by the JAX package
(its vocabulary trained by the JAX ``train_vocab``), which each package
loads with its own ``load_map``.

Tolerances: the same keyframe frame ids; map points within 2; each ATE
under the JAX test's 0.3 m and the two within 0.02 m
(``tests/test_torch_system.py``'s rule). The resumed session is compared
by its ATE from the relocalized frame on, not pose by pose: its segment
hangs on the loaded map through the seed keyframe's 1e6·I covariance, so
local BA's f32 sums, in another order in each package, move its later
keyframes by centimetres (a reference property, ``ROADMAP.md`` §3). The
JAX test's own asserts are made on the port's run too.
"""
import dataclasses

import numpy as np
import torch

from se2lam_tpu.config import Capacity, SystemConfig
from se2lam_tpu.frontend.orb import OrbConfig
from se2lam_tpu.io import SyntheticWorld, save_map
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu.vocab import train_vocab
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io.trajectory import ate_se2
from se2lam_tpu_torch.system import SlamSystem

from jax_draws import jax_reloc_noise, jax_stage_keys, run_jax_slam, stage_gumbel
from synth_utils import TCB
from test_prune import check_consistency

torch.set_num_threads(2)
N_FRAMES = 36


def _cfg(**kw):
    oc = OrbConfig(height=240, width=320, n_features=256, scale_factor=1.2, n_levels=2)
    return SystemConfig(
        width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        Tbc=tuple(np.linalg.inv(TCB).ravel()), upper_depth=30.0, lower_depth=0.2,
        max_feature_num=256, max_level=2,
        min_frames_between_kf=2, max_frames_between_kf=8, local_iter=6,
        cap=Capacity(n_features=oc.n_slots, max_kfs=64, max_mps=4096, local_kfs=8,
                     local_ref_kfs=8, local_mps=512, ransac_trials=64), **kw)


def _tcfg(cfg):
    return config_from_fields(dataclasses.asdict(cfg))


def test_slam_with_distortion_matches_jax():
    cfg = _cfg(dist=(-0.25, 0.08, 0.0005, -0.0005, 0.0))
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    seq = list(world.sequence(N_FRAMES, noise=(0.002, 0.001, 0.001)))
    js = JaxSlam(cfg, enable_loops=False)
    ts = SlamSystem(_tcfg(cfg), enable_loops=False, device="cpu")
    assert js._undistort and ts._undistort
    noise = run_jax_slam(js, seq)
    for (img, odo), g in zip(seq, noise):
        ts.process(img, odo, gumbel=g)
    assert ts.kf_frame_ids == js.kf_frame_ids
    assert ts.n_keyframes() >= 3 and ts.n_map_points() > 40
    assert abs(ts.n_map_points() - js.n_map_points()) <= 2
    ate = {}
    for name, s in (("jax", js), ("port", ts)):
        est = np.asarray([p for _, p in s.trajectory])
        ate[name] = ate_se2(est[:, :2], world.gt[: len(est), :2])[0]
        assert ate[name] < 0.3, (name, ate[name])
    assert abs(ate["jax"] - ate["port"]) < 0.02, ate


def test_resume_with_loops_enabled_matches_jax(tmp_path):
    """50 frames mapped and saved with a 256-word vocabulary, then
    ``SlamSystem.resume(..., enable_loops=True)`` over frames 15-34 of a
    second lap: the JAX test's asserts (finite poses and points, keyframes,
    consistent tables) on the port's map, and the port's session equal to
    JAX's."""
    cfg = _cfg(gm_dcl_min_kfid_offset=8, gm_vcl_num_min_match_mp=6,
               gm_vcl_num_min_match_kp=15)
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    slam = JaxSlam(cfg, enable_loops=False)
    for img, odo in world.sequence(50, noise=(0.001, 0.001, 0.0005)):
        slam.process(img, odo)
    desc = slam.ms.kf_desc.reshape(-1, 256)
    valid = (slam.ms.kf_feat_valid & slam.ms.kf_valid[:, None]).reshape(-1)
    path = str(tmp_path / "map")
    save_map(path, slam.ms, train_vocab(desc, valid, n_words=256, iters=5))

    gt = world.circle_trajectory(60)
    odo = world.odometry(gt, noise=(0.002, 0.001, 0.001), seed=9)
    frames = [(world.render(gt[i]), odo[i]) for i in range(15, 35)]
    js = JaxSlam.resume(cfg, path, enable_loops=True)
    with jax_stage_keys() as keys:
        noise = run_jax_slam(js, frames)

    T, N = cfg.cap.ransac_trials, cfg.cap.n_features
    ts = SlamSystem.resume(_tcfg(cfg), path, enable_loops=True, device="cpu")
    ts._reloc_localizer.reloc_gumbel = jax_reloc_noise(T, N)
    stages = iter(keys)
    ts._loop_closer.stage_gumbel = lambda: stage_gumbel(next(stages), T, N)
    for (img, o), g in zip(frames, noise):
        ts.process(img, o, gumbel=g)

    assert bool(torch.isfinite(ts.ms.kf_pose).all()) and bool(torch.isfinite(ts.ms.mp_pos).all())
    assert ts.n_keyframes() > 0
    check_consistency(ts.ms)
    assert next(stages, None) is None, "the port ran fewer loop stages than JAX"
    assert ts.kf_frame_ids == js.kf_frame_ids
    assert ts.n_keyframes() == js.n_keyframes() > slam.n_keyframes()
    assert ts._loop_closer.n_loops_closed == js._loop_closer.n_loops_closed
    seed = js.kf_frame_ids[slam.n_keyframes()]       # the relocalized frame
    ate = {}
    for name, s in (("jax", js), ("port", ts)):
        fid, est = zip(*[(f, p) for f, p in s.trajectory if f >= seed])
        ate[name] = ate_se2(np.asarray(est)[:, :2], gt[15 + np.asarray(fid), :2])[0]
        assert ate[name] < 0.3, (name, ate[name])
    assert abs(ate["jax"] - ate["port"]) < 0.02, ate
