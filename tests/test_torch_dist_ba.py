"""The port's map-block partitioned BA (``parallel/dist_ba.py``) against
the JAX package's on the conftest's 8 CPU devices, the port's mesh being
n blocks on the CPU (``make_mesh(n, device="cpu")``).

- ``partition_points`` bitwise the JAX partition, field by field in the
  concatenated layout, with ``n_obs_dropped``: n = 2 and 8, the generic
  path (M not a multiple of n, so the points pad) and the M×P grid path,
  and a capacity that overflows;
- ``sharded_solve_local_ba`` against JAX's at n = 2 and 8, and against the
  port's own single-device ``solve_local_ba``: poses within 5e-4, points
  within 2e-3, chi2 within rtol 1e-2 / atol 1e-3 (``tests/test_parallel.py``:
  the blocks' psum and the single accumulation sum in other orders);
- ``dist_solve_local_ba`` on JAX's own partition (``convert.
  dist_ba_problem_from_numpy``) against JAX's, with the same tolerances;
- ``sharded_solve_joint_ba`` (the matrix-free PCG, ``grid_p``) against the
  single-device optimum within 1e-2 and with the cost below 1e-3 of the
  start's (``tests/test_parallel.py``), with each preconditioner.
"""
import numpy as np
import pytest
import torch

from se2lam_tpu.parallel import make_mesh as jmesh
from se2lam_tpu.parallel import partition_points as jpartition
from se2lam_tpu.parallel import sharded_solve_local_ba as jsharded
from se2lam_tpu.solver import BAConfig as JCfg
from se2lam_tpu.solver.ba import synthetic_grid_ba as jgrid
from se2lam_tpu.parallel import dist_solve_local_ba as jdist_solve
from se2lam_tpu_torch.convert import ba_problem_from_numpy, dist_ba_problem_from_numpy
from se2lam_tpu_torch.ops.camera import CameraModel
from se2lam_tpu_torch.parallel import (
    dist_solve_local_ba, gather, make_mesh, partition_points, sharded_solve_joint_ba,
    sharded_solve_local_ba,
)
from se2lam_tpu_torch.solver.ba import BAConfig, ba_chi2, solve_local_ba, synthetic_grid_ba

from test_parallel import _perturbed_problem

torch.set_num_threads(2)

TCB = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float32)


def _port_cam(cam):
    return CameraModel.create(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                              np.asarray(cam.dist), device="cpu")


def _assert_partition_equal(dp, jdp):
    got = dp.gathered()
    for k, v in got.items():
        want = np.asarray(getattr(jdp, k))
        assert v.numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    assert int(dp.n_obs_dropped) == int(jdp.n_obs_dropped)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("cap", ["roomy", "tight"])
def test_partition_points_bitwise_jax(n, cap):
    jprob, _, _ = _perturbed_problem(K=8, M=50)       # 50 points pad at n = 8
    O = jprob.obs_kf.shape[0]
    obs_cap = max(1, -(-O // n) * 2) if cap == "roomy" else 3
    jdp = jpartition(jprob, n=n, obs_cap=obs_cap)
    dp = partition_points(ba_problem_from_numpy(jprob, "cpu"), n, obs_cap)
    _assert_partition_equal(dp, jdp)
    assert len(dp.points) == n and dp.points[0].shape[0] == -(-50 // n)
    if cap == "tight":
        assert int(dp.n_obs_dropped) > 0


@pytest.mark.parametrize("n", [2, 8])
def test_partition_points_grid_bitwise_jax(n):
    from se2lam_tpu.ops.camera import CameraModel as JCam
    import jax.numpy as jnp

    cam = JCam.create(500.0, 500.0, 320.0, 240.0)
    jprob, _ = jgrid(np.random.default_rng(0), 16, 256, 8, cam, jnp.asarray(TCB))
    jdp = jpartition(jprob, n=n, obs_cap=(256 // n) * 8, grid=True)
    dp = partition_points(ba_problem_from_numpy(jprob, "cpu"), n, (256 // n) * 8, grid=True)
    _assert_partition_equal(dp, jdp)
    assert int(dp.n_obs_dropped) == 0


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_ba_matches_jax_and_single_device(n):
    jprob, jcam, jTcb = _perturbed_problem()
    cfg = BAConfig(iters=6)
    prob = ba_problem_from_numpy(jprob, "cpu")
    cam, Tcb = _port_cam(jcam), torch.from_numpy(np.asarray(jTcb))
    jp, jx, jinfo = jsharded(jprob, jcam, jTcb, JCfg(iters=6), jmesh(n))
    p1, x1, info1 = solve_local_ba(prob, cam, Tcb, cfg)
    p, x, info = sharded_solve_local_ba(prob, cam, Tcb, cfg, make_mesh(n, device="cpu"))
    assert int(info["n_obs_dropped"]) == 0
    assert p.shape == p1.shape and x.shape == x1.shape
    for poses, points, chi2 in ((np.asarray(jp), np.asarray(jx), float(jinfo["chi2"])),
                                (p1.numpy(), x1.numpy(), float(info1["chi2"]))):
        np.testing.assert_allclose(p.numpy(), poses, atol=5e-4)
        np.testing.assert_allclose(x.numpy(), points, atol=2e-3)
        np.testing.assert_allclose(float(info["chi2"]), chi2, rtol=1e-2, atol=1e-3)
    assert float(info["chi2"]) < 1e-3 * float(info["chi2_init"])


def test_dist_solve_on_jax_partition_matches_jax():
    jprob, jcam, jTcb = _perturbed_problem(K=8, M=50)
    n, O = 4, jprob.obs_kf.shape[0]
    jdp = jpartition(jprob, n=n, obs_cap=-(-O // n) * 2)
    jp, jx, jinfo = jdist_solve(jdp, jcam, jTcb, JCfg(iters=6), jmesh(n))
    dp = dist_ba_problem_from_numpy(jdp, n, "cpu")
    assert len(dp.obs_uv) == n
    p, x_b, info = dist_solve_local_ba(dp, _port_cam(jcam), torch.from_numpy(np.asarray(jTcb)),
                                       BAConfig(iters=6), make_mesh(n, device="cpu"))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=5e-4)
    np.testing.assert_allclose(gather(x_b).numpy(), np.asarray(jx), atol=2e-3)
    np.testing.assert_allclose(float(info["chi2"]), float(jinfo["chi2"]), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("precond", ["tridiag", "jacobi"])
def test_sharded_joint_ba_pcg_matches_optimum(precond):
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device="cpu")
    Tcb = torch.from_numpy(TCB)
    P = 8
    prob, _ = synthetic_grid_ba(np.random.default_rng(0), 32, 1024, P, cam, Tcb)
    cfg = BAConfig(iters=8)
    p_ref, _, _ = solve_local_ba(prob, cam, Tcb, cfg)
    p, x, info = sharded_solve_joint_ba(prob, cam, Tcb, cfg, make_mesh(8, device="cpu"),
                                        cg_iters=32, grid_p=P, precond=precond)
    assert int(info["n_obs_dropped"]) == 0
    d = (p - p_ref).numpy()
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    assert float(np.abs(d).max()) < 1e-2, float(np.abs(d).max())
    assert bool(torch.isfinite(x).all())
    c = float(ba_chi2(prob._replace(poses=p, points=x), cam, Tcb, cfg.huber_delta))
    c0 = float(ba_chi2(prob, cam, Tcb, cfg.huber_delta))
    assert c < 1e-3 * c0, (c, c0)


def test_sharded_joint_ba_generic_partition():
    """Without the grid promise the PCG solver bucket-scatters its point
    sums; the same optimum."""
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device="cpu")
    Tcb = torch.from_numpy(TCB)
    prob, _ = synthetic_grid_ba(np.random.default_rng(1), 16, 256, 8, cam, Tcb)
    cfg = BAConfig(iters=8)
    p_ref, _, _ = solve_local_ba(prob, cam, Tcb, cfg)
    p, _, info = sharded_solve_joint_ba(prob, cam, Tcb, cfg, make_mesh(4, device="cpu"),
                                        cg_iters=32)
    assert int(info["n_obs_dropped"]) == 0
    assert float((p - p_ref).abs().max()) < 1e-2
