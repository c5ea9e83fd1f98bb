"""The port's studies and soak (``se2lam_tpu_torch/drivers/study_*.py``,
``soak_bank_scale.py``) against the JAX package's scripts in ``examples/``,
imported here as modules, on the CPU at small sizes:

- every configuration the scripts build equals the driver's, field by
  field (``dataclasses.asdict``);
- ``lap_drift`` and ``_rel_to_start`` within 1e-12 on seeded trajectories;
- ``check_consistency_fast`` of both packages passes on a small map and
  raises on a copy with one forward pointer corrupted;
- ``study_vocab_scale.run_one`` at one small (K, W) with the JAX draw of
  the vocabulary's seed rows;
- ``study_tri_accuracy``'s per-gap errors on two frame pairs a gap;
- ``study_pcg_precond``'s joint solve at K = 32, M = 512 on 2 blocks for
  each preconditioner.
"""
import contextlib
import dataclasses
import io
import os
import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.ops.camera import CameraModel as JCam
from se2lam_tpu.parallel import make_mesh as jmesh
from se2lam_tpu.parallel import sharded_solve_joint_ba as jsolve
from se2lam_tpu.solver import BAConfig as JCfg
from se2lam_tpu.solver.ba import synthetic_grid_ba as jgrid
from se2lam_tpu_torch.drivers import soak_bank_scale as t_soak
from se2lam_tpu_torch.drivers import study_drift as t_drift
from se2lam_tpu_torch.drivers import study_noise as t_noise
from se2lam_tpu_torch.drivers import study_pcg_precond as t_pcg
from se2lam_tpu_torch.drivers import study_pg_calib as t_pg
from se2lam_tpu_torch.drivers import study_tri_accuracy as t_tri
from se2lam_tpu_torch.drivers import study_vocab_scale as t_vocab
from se2lam_tpu_torch.ops.camera import CameraModel
from se2lam_tpu_torch.parallel import make_mesh
from se2lam_tpu_torch.solver.ba import BAConfig, synthetic_grid_ba

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))
import soak_bank_scale as j_soak  # noqa: E402
import study_drift as j_drift  # noqa: E402
import study_tri_accuracy as j_tri  # noqa: E402
import study_vocab_scale as j_vocab  # noqa: E402

torch.set_num_threads(2)

TCB = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("kw", [{}, {"joint_iters": 0}, {"n_feats": 128},
                                {"odo_noise": (0.006, 0.003, 0.003)}],
                         ids=["default", "joint_iters_0", "n_feats_128", "soak_noise"])
def test_build_cfg_matches_jax(kw):
    assert _fields(t_drift.build_cfg(**kw)) == _fields(j_drift.build_cfg(**kw))


def test_soak_cfg_matches_jax():
    noise = (0.006, 0.003, 0.003)
    want = j_drift.build_cfg(odo_noise=noise).replace(min_frames_between_kf=2,
                                                      max_frames_between_kf=4)
    assert _fields(t_soak.soak_cfg(noise)) == _fields(want)


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0, 4.0])
def test_noise_modes_match_jax(scale):
    """study_noise.py's four estimator noise models at each default scale."""
    base = np.asarray([0.012, 0.006, 0.006])
    want = {"default_0.001": (0.001, 0.001, 0.001), "half": tuple(0.5 * base * scale),
            "matched": tuple(base * scale), "double": tuple(2.0 * base * scale)}
    assert t_noise.MODES == tuple(want)
    for mode, noise in want.items():
        assert t_noise.mode_noise(mode, scale) == noise
        assert (_fields(t_drift.build_cfg(odo_noise=t_noise.mode_noise(mode, scale)))
                == _fields(j_drift.build_cfg(odo_noise=noise)))


@pytest.mark.parametrize("huber", [1e9, 3.0, 1.0])
def test_pg_calib_grid_matches_jax(huber):
    for ceil in (1e4, 1e3, 3e2, 1e2):
        want = j_drift.build_cfg(joint_iters=0).replace(gm_pg_huber=float(huber),
                                                        gm_loop_info_ceil=float(ceil))
        assert _fields(t_pg.grid_cfg(huber, ceil)) == _fields(want)


@pytest.mark.parametrize("n,fpl", [(270, 90), (200, 90), (45, 90)])
def test_lap_drift_matches_jax(n, fpl):
    rng = np.random.default_rng(n)
    gt = np.cumsum(rng.normal(0, 0.1, (n, 3)), 0)
    est = gt + rng.normal(0, 0.05, (n, 3))
    np.testing.assert_allclose(t_drift._rel_to_start(est), j_drift._rel_to_start(est),
                               rtol=0, atol=1e-12)
    got, want = t_drift.lap_drift(est, gt, fpl), j_drift.lap_drift(est, gt, fpl)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_lap_sequence_matches_the_scripts_ground_truth():
    """The drivers' ``lap_sequence`` is the scripts' tiled circle."""
    from se2lam_tpu_torch.io import SyntheticWorld

    world = SyntheticWorld(t_drift.build_cfg(), n_landmarks=600, room=10.0, seed=4)
    lap = world.circle_trajectory(90)
    for laps in (1.0, 2.0, 2.5, 3.0):
        n = int(laps * 90)
        want = np.concatenate([lap] * int(np.ceil(n / 90)))[:n]
        np.testing.assert_array_equal(t_drift.lap_sequence(world, laps, 90), want)


@pytest.fixture(scope="module")
def small_map():
    """A map of the port at the drift study's 320x240 configuration (loops
    off, the first 20 frames of its world and odometry draw 3)."""
    from se2lam_tpu_torch.io import SyntheticWorld
    from se2lam_tpu_torch.system import SlamSystem

    cfg = t_drift.build_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    gt = t_drift.lap_sequence(world, 1.0, 90)[:20]
    odo = world.odometry(gt, noise=(0.012, 0.006, 0.006), seed=3)
    slam = SlamSystem(cfg, enable_loops=False, device="cpu")
    for p, o in zip(gt, odo):
        slam.process(world.render(p), o)
    assert slam.n_keyframes() >= 3 and slam.n_map_points() > 20
    return slam.ms


_TABLES = ("mp_obs_kf", "mp_obs_feat", "kf_obs_mp", "mp_n_obs", "mp_valid", "kf_valid")


def _numpy_map(ms):
    return types.SimpleNamespace(**{k: getattr(ms, k).numpy() for k in _TABLES})


def test_check_consistency_fast_both_packages(small_map):
    t_soak.check_consistency_fast(small_map)
    j_soak.check_consistency_fast(_numpy_map(small_map))


def test_check_consistency_fast_both_raise_on_a_corrupt_pointer(small_map):
    ks, fs = np.nonzero(small_map.kf_obs_mp.numpy() >= 0)
    k, f = int(ks[0]), int(fs[0])
    mp = int(small_map.kf_obs_mp[k, f])
    other = int(np.nonzero(small_map.mp_valid.numpy() & (np.arange(small_map.M) != mp))[0][0])
    bad = small_map._replace(kf_obs_mp=small_map.kf_obs_mp.clone())
    bad.kf_obs_mp[k, f] = other
    with pytest.raises(AssertionError, match="pointer"):
        t_soak.check_consistency_fast(bad)
    with pytest.raises(AssertionError, match="pointer"):
        j_soak.check_consistency_fast(_numpy_map(bad))


def test_vocab_scale_matches_jax_with_its_seed_rows():
    """One small cell (K = 16 keyframes, W = 64 words): the JAX draw of
    the seed rows (``jax.random.choice`` of ``train_vocab``; D = K * 128 a
    power of two, so the uniform choice's cumulative sum is exact) given
    to the port. Both scripts round the scores' statistics to 4 decimals."""
    K, W, F, seed = 16, 64, 128, 0
    D = K * F
    p = jnp.ones((D,), jnp.float32) / D
    seed_idx = np.asarray(jax.jit(lambda k: jax.random.choice(
        k, D, shape=(W,), replace=True, p=p))(jax.random.PRNGKey(seed)))
    want = j_vocab.run_one(K, W)
    got = t_vocab.run_one(K, W, device="cpu", seed_idx=torch.from_numpy(seed_idx.copy()))
    assert got["top1_acc"] == want["top1_acc"]
    for k in ("sep_mean", "sep_min", "impostor_mean"):
        assert abs(got[k] - want[k]) <= 1e-4 + 1e-6, (k, got, want)


def test_tri_accuracy_matches_jax():
    """Two frame pairs a gap (starts 0 and 10): the JAX script's printed
    lines, read back, against the port's figures at the script's
    precision (3 decimals; the DLT's f32 sums may move the last)."""
    starts = range(0, 20, 10)
    buf = io.StringIO()
    j_tri.range = lambda *a: starts          # the script's frame loop
    try:
        with contextlib.redirect_stdout(buf):
            j_tri.main()
    finally:
        del j_tri.range
    got = t_tri.run("cpu", starts=starts)
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == len(t_tri.GAPS)
    for ln in lines:
        m = re.match(r"gap=(\d+): n=(\d+) err med=([\d.]+) p90=([\d.]+) "
                     r"frac>0.5m=([\d.]+) depth med=([\d.]+)", ln)
        gap, n = int(m[1]), int(m[2])
        r = got[gap]
        assert r["n"] == n, (gap, r, ln)
        for key, val, tol in (("err_med", m[3], 1.5e-3), ("err_p90", m[4], 1.5e-3),
                              ("frac_gt_0.5m", m[5], 1e-2), ("depth_med", m[6], 1.5e-2)):
            assert abs(r[key] - float(val)) <= tol, (gap, key, r[key], val)


def test_pcg_precond_rows_match_jax():
    """The study's joint solve at K = 32, M = 512, P = 6 on 2 blocks, 5 LM
    steps, 8 CG steps, for each preconditioner: the pose error against
    ground truth equal to JAX's within 1e-4 (f32 sums in another order,
    over 5 LM steps of a PCG that is stopped early; the poses part by
    about 3e-5)."""
    K, M, P, cg = 32, 512, 6, 8
    jcam = JCam.create(500.0, 500.0, 320.0, 240.0)
    jprob, jgt = jgrid(np.random.default_rng(0), K, M, P, jcam, jnp.asarray(TCB))
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device="cpu")
    Tcb = torch.from_numpy(TCB)
    prob, gt = synthetic_grid_ba(np.random.default_rng(0), K, M, P, cam, Tcb)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    rows = t_pcg.joint_rows(prob, gt, cam, Tcb, BAConfig(iters=5), make_mesh(2, device="cpu"),
                            [cg], P)
    for row in rows:
        jp, _, _ = jsolve(jprob, jcam, jnp.asarray(TCB), JCfg(iters=5), jmesh(2), cg_iters=cg,
                          grid_p=P, precond=row["precond"])
        want = t_pcg.wrapped_err(np.asarray(jp), np.asarray(jgt))
        assert abs(row["pose_err"] - want) <= 1e-4, (row, want)


def test_driver_runs_as_a_module_and_writes_its_results(tmp_path):
    """``python -m se2lam_tpu_torch.drivers.study_vocab_scale`` on the CPU
    writes the dict its ``run`` returns."""
    import json
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "se2lam_tpu_torch.drivers.study_vocab_scale", "--Ks", "8",
         "--Ws", "16", "--device", "cpu", "--out", str(tmp_path)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(tmp_path / "results.json") as f:
        rows = json.load(f)["rows"]
    want = t_vocab.run(t_vocab.parse_args(["--Ks", "8", "--Ws", "16", "--device", "cpu",
                                           "--out", str(tmp_path / "again")]))["rows"]
    assert rows == want and rows[0]["K"] == 8 and rows[0]["W"] == 16
