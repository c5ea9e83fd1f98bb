"""The port's pose-only solver against the JAX package's: a synthetic
camera pose perturbed from the truth, fixed world points with pixel noise,
gross outliers and invalid slots.

Tolerances: the pose within 1e-4 and chi2 within 1e-4 relative (f32
sums in another order); ``n_inliers`` within 1, since an observation on
the Huber threshold may fall either way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.ops.camera import CameraModel as JCam
from se2lam_tpu.solver.poseonly import solve_pose_only as jsolve
from se2lam_tpu_torch.ops.camera import CameraModel as TCam
from se2lam_tpu_torch.solver.poseonly import solve_pose_only as tsolve

from synth_utils import TCB, se2_mat

torch.set_num_threads(2)
FX, FY, CX, CY = 260.0, 260.0, 160.0, 120.0


def _problem(seed, M=200, outliers=0.15, noise_px=0.7):
    rng = np.random.default_rng(seed)
    true = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-np.pi, np.pi)])
    # points in front of the camera (body +x), 2-8 m out
    d = rng.uniform(2.0, 8.0, M)
    lat = rng.uniform(-0.5, 0.5, M) * d
    h = rng.uniform(-0.4, 0.4, M) * d
    pb = np.stack([d, lat, h, np.ones(M)], 1)
    pw = (se2_mat(true) @ pb.T).T[:, :3]
    lc = (TCB @ pb.T).T[:, :3]
    uv = np.stack([FX * lc[:, 0] / lc[:, 2] + CX, FY * lc[:, 1] / lc[:, 2] + CY], 1)
    uv += rng.normal(0, noise_px, uv.shape)
    bad = rng.random(M) < outliers
    uv[bad] += rng.uniform(30, 80, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    valid = rng.random(M) > 0.05
    init = true + np.array([rng.normal(0, 0.08), rng.normal(0, 0.08), rng.normal(0, 0.04)])
    return (init.astype(np.float32), pw.astype(np.float32), uv.astype(np.float32), valid,
            true)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_pose_only_matches_jax(seed):
    init, pw, uv, valid, true = _problem(seed)
    Tcb = TCB.astype(np.float32)
    jp, jchi, jn = jsolve(jnp.asarray(init), jnp.asarray(pw), jnp.asarray(uv),
                          jnp.asarray(valid), JCam.create(FX, FY, CX, CY), jnp.asarray(Tcb))
    tp, tchi, tn = tsolve(torch.from_numpy(init), torch.from_numpy(pw), torch.from_numpy(uv),
                          torch.from_numpy(valid), TCam.create(FX, FY, CX, CY, device="cpu"),
                          torch.from_numpy(Tcb))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-4)
    assert abs(int(tn) - int(jn)) <= 1
    # it solved: the truth up to the noise, the outliers out
    assert np.abs(tp.numpy()[:2] - true[:2]).max() < 0.05
    assert int(tn) < valid.sum()


def test_no_valid_observation_keeps_the_pose():
    init, pw, uv, valid, _ = _problem(5)
    p, _, n = tsolve(torch.from_numpy(init), torch.from_numpy(pw), torch.from_numpy(uv),
                     torch.zeros(len(valid), dtype=torch.bool),
                     TCam.create(FX, FY, CX, CY, device="cpu"),
                     torch.from_numpy(TCB.astype(np.float32)))
    assert torch.isfinite(p).all() and int(n) == 0
    np.testing.assert_allclose(p.numpy(), init, atol=1e-6)
