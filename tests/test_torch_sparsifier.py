"""The port's loop-pair sparsifier and 2-KF mini-BA constraint against the
JAX package's.

- ``marginalize_pair_constraint`` on the scene of
  ``tests/test_loopclose.py::test_pair_constraint_info_spd_and_scales``
  (40 points 3-6 m ahead, a 0.5 m pair), with every point and with 8:
  ``meas`` within 1e-6, ``info`` within 2e-4 of max|info| (the port reads
  5e-5: the f32 Jacobian sums and ``eigh`` round apart; the clamp at 1e4
  is exact), and the JAX test's own asserts on the port's result.
- ``build_loop_constraint_ba`` on a map the JAX package builds with the
  synthetic geometry of ``tests/test_outliers.py`` (11 frames, 3
  keyframes, 64 features), carried across with ``map_state_from_numpy``,
  with the match indices of JAX's ``verify_loop``: ``good`` and ``n_good``
  equal, ``meas`` within 1e-5 (the port reads 2.4e-7 after 10 f32 LM
  steps) and ``info`` within 2e-4 of max|info| (the port reads 2.8e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import factors as jfactors
from se2lam_tpu import loopclose as jlc
from se2lam_tpu.ops import se2 as jse2
from se2lam_tpu.ops.camera import CameraModel as JaxCam
from se2lam_tpu.solver.sparsifier import marginalize_pair_constraint as jax_marg
from se2lam_tpu_torch import factors as tfactors
from se2lam_tpu_torch import loopclose as tlc
from se2lam_tpu_torch.convert import config_from_fields, map_state_from_numpy
from se2lam_tpu_torch.ops.camera import CameraModel
from se2lam_tpu_torch.solver.sparsifier import marginalize_pair_constraint

from synth_utils import TCB, make_cfg, make_scene
from test_localmap import drive_frames, motion_poses

torch.set_num_threads(2)

INFO_RTOL = 2e-4     # of max|info| (module docstring)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_spd_clamped(info):
    """The JAX test's assert on ``info``: symmetric positive definite, its
    eigenvalues under the 1e4 clamp."""
    np.testing.assert_array_equal(info, info.T)
    ev = np.linalg.eigvalsh(info.astype(np.float64))
    assert (ev > 0).all() and (ev <= 1e4 + 1).all()


@pytest.mark.parametrize("n_valid", [40, 8], ids=["many", "few"])
def test_pair_constraint_matches_jax(n_valid):
    rng = np.random.default_rng(0)
    cam = JaxCam.create(420.0, 420.0, 320.0, 240.0)
    Tcb = jnp.asarray(TCB, jnp.float32)
    pose_i, pose_j = jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([0.5, 0.1, 0.05])
    M = 40
    pts = jnp.asarray(np.stack([rng.uniform(3, 6, M), rng.uniform(-2, 2, M),
                                rng.uniform(-1, 1, M)], -1), jnp.float32)

    def uv_of(pose):
        return jax.vmap(lambda x: jfactors.se2xyz_residual(pose, x, jnp.zeros(2), cam, Tcb))(pts)

    uv_i, uv_j = uv_of(pose_i), uv_of(pose_j)
    mask = jnp.arange(M) < n_valid
    want_meas, want_info = map(np.asarray, jax_marg(pose_i, pose_j, pts, uv_i, uv_j, mask,
                                                    cam, Tcb))
    meas, info = marginalize_pair_constraint(
        _t(pose_i), _t(pose_j), _t(pts), _t(uv_i), _t(uv_j), _t(mask),
        CameraModel.create(420.0, 420.0, 320.0, 240.0, device="cpu"), _t(Tcb))
    meas, info = meas.numpy(), info.numpy()
    np.testing.assert_allclose(meas, want_meas, atol=1e-6)
    np.testing.assert_allclose(meas, np.asarray(jse2.minus(pose_j, pose_i)), atol=1e-6)
    np.testing.assert_allclose(info, want_info, rtol=0,
                               atol=INFO_RTOL * np.abs(want_info).max())
    _assert_spd_clamped(info)


def test_more_points_give_more_information():
    """The JAX test's trace assert on the port alone: 40 points carry more
    information than 8."""
    rng = np.random.default_rng(0)
    cam = CameraModel.create(420.0, 420.0, 320.0, 240.0, device="cpu")
    Tcb = torch.from_numpy(TCB.astype(np.float32))
    pose_i, pose_j = torch.zeros(3), torch.tensor([0.5, 0.1, 0.05])
    M = 40
    pts = torch.from_numpy(np.stack([rng.uniform(3, 6, M), rng.uniform(-2, 2, M),
                                     rng.uniform(-1, 1, M)], -1).astype(np.float32))
    uv_i = tfactors.se2xyz_residual(pose_i, pts, torch.zeros(2), cam, Tcb)
    uv_j = tfactors.se2xyz_residual(pose_j, pts, torch.zeros(2), cam, Tcb)
    traces = [float(torch.trace(marginalize_pair_constraint(
        pose_i, pose_j, pts, uv_i, uv_j, torch.arange(M) < n, cam, Tcb)[1])) for n in (M, 8)]
    assert traces[0] > traces[1]


@pytest.fixture(scope="module")
def small_map():
    """A JAX-built map of the synthetic geometry (3 keyframes) and both
    packages' configs."""
    cfg = make_cfg()
    pts, bits = make_scene(np.random.default_rng(0))
    poses = motion_poses(11)
    ms, kfs = drive_frames(cfg, poses, poses, pts, bits)
    assert len(kfs) == 3
    return cfg, config_from_fields(dataclasses.asdict(cfg)), ms, kfs


@pytest.mark.parametrize("cand_i", [0, 1])
def test_mini_ba_constraint_matches_jax(small_map, cand_i):
    cfg, tcfg, ms, kfs = small_map
    k, cand = kfs[-1], kfs[cand_i]
    midx, n_kp, _, _ = jlc.verify_loop(ms, jnp.asarray(k), jnp.asarray(cand),
                                       jax.random.PRNGKey(3), n_trials=64)
    assert int(n_kp) >= 20
    want = jax.tree.map(np.asarray, jlc.build_loop_constraint_ba(
        ms, jnp.asarray(k), jnp.asarray(cand), midx, cfg))
    tms = map_state_from_numpy(jax.tree.map(np.asarray, ms), "cpu")
    meas, info, n_good, good = tlc.build_loop_constraint_ba(
        tms, torch.tensor(k), torch.tensor(cand), _t(midx), tcfg)
    np.testing.assert_array_equal(good.numpy(), want[3])
    assert int(n_good) == int(want[2]) >= 20 and n_good.dtype == torch.int32
    np.testing.assert_allclose(meas.numpy(), want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(info.numpy(), want[1], rtol=0,
                               atol=INFO_RTOL * np.abs(want[1]).max())
    _assert_spd_clamped(info.numpy())
