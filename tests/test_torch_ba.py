"""The port's factors and SE2-XYZ local BA against the JAX package's, on
the same inputs (made with numpy, carried across as arrays).

Tolerances: factor values within 1e-5 relative and Jacobians within 1e-4
(sin/cos and the 1/z products round differently in the two libraries);
the assembled system within 1e-4 of its largest entry (scatter sums in
another order); a solve descends by more than 4 orders in both packages,
with final chi2 within 1e-3 relative and poses within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import factors as jf
from se2lam_tpu.ops.camera import CameraModel as JCam
from se2lam_tpu.solver import ba as jba
from se2lam_tpu_torch import factors as tf
from se2lam_tpu_torch.convert import ba_problem_from_numpy
from se2lam_tpu_torch.ops.camera import CameraModel as TCam
from se2lam_tpu_torch.solver import ba as tba

from synth_utils import TCB

torch.set_num_threads(2)

FX, FY, CX, CY = 420.0, 410.0, 320.0, 240.0
B = 64


def _cams():
    return JCam.create(FX, FY, CX, CY), TCam.create(FX, FY, CX, CY, device="cpu")


def _tcb():
    return jnp.asarray(TCB, jnp.float32), torch.from_numpy(TCB.astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _random_geometry(rng):
    poses = np.stack([rng.uniform(-2, 2, B), rng.uniform(-2, 2, B),
                      rng.uniform(-np.pi, np.pi, B)], -1).astype(np.float32)
    # points 2-8 m ahead of each pose along body +x, with lateral spread
    fwd = rng.uniform(2, 8, B)
    lat = rng.uniform(-2, 2, B)
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    pts = np.stack([poses[:, 0] + c * fwd - s * lat, poses[:, 1] + s * fwd + c * lat,
                    rng.uniform(-1, 1, B)], -1).astype(np.float32)
    uv = rng.uniform(0, 640, (B, 2)).astype(np.float32)
    return poses, pts, uv


def _case_residual_jac(rng):
    jcam, tcam = _cams()
    jT, tT = _tcb()
    p, x, uv = _random_geometry(rng)
    want = jax.vmap(lambda a, b, c: jf.se2xyz_residual_jac(a, b, c, jcam, jT))(p, x, uv)
    got = tf.se2xyz_residual_jac(_t(p), _t(x), _t(uv), tcam, tT)
    _close(got[0], want[0], 1e-5, 1e-3)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-4, 1e-3)
    r = jax.vmap(lambda a, b, c: jf.se2xyz_residual(a, b, c, jcam, jT))(p, x, uv)
    _close(tf.se2xyz_residual(_t(p), _t(x), _t(uv), tcam, tT), r, 1e-5, 1e-3)
    z = jax.vmap(lambda a, b: jf.se2xyz_depth(a, b, jT))(p, x)
    _close(tf.se2xyz_depth(_t(p), _t(x), tT), z, 1e-5, 1e-6)


def _case_huber(rng):
    chi2 = rng.uniform(0, 100, B).astype(np.float32)
    _close(tf.huber_rho(_t(chi2), 5.0), jf.huber_rho(chi2, 5.0), 1e-6)


def _case_pixel_jacobian(rng):
    jcam, tcam = _cams()
    lc = np.stack([rng.uniform(-2, 2, B), rng.uniform(-2, 2, B),
                   rng.uniform(1, 8, B)], -1).astype(np.float32)
    _close(tf.pixel_jacobian(_t(lc), tcam), jf.pixel_jacobian(jnp.asarray(lc), jcam), 1e-5)


def _case_sigma(rng):
    jcam, tcam = _cams()
    jT, tT = _tcb()
    p, x, _ = _random_geometry(rng)
    sigma2 = rng.uniform(1, 3, B).astype(np.float32)
    from se2lam_tpu.mapstate import kf_Tcw
    Tcw = jax.vmap(lambda q: kf_Tcw(q, jT))(p)
    lc = jnp.einsum("bij,bj->bi", Tcw[:, :3, :3], x) + Tcw[:, :3, 3]
    want = jax.vmap(lambda a, b, c, d, e: jf.se2xyz_sigma(a, b, c, jcam, d, e, 1e-6, 1.0))(
        p, x, lc, Tcw, sigma2)
    got = tf.se2xyz_sigma(_t(p), _t(x), _t(lc), tcam, _t(Tcw), _t(sigma2), 1e-6, 1.0)
    _close(got, want, 1e-4, 1e-6)


def _case_pre_se2(rng):
    pi, pj, _ = _random_geometry(rng)
    meas = rng.normal(0, 0.3, (B, 3)).astype(np.float32)
    want = jax.vmap(jf.pre_se2_residual_jac)(pi, pj, meas)
    got = tf.pre_se2_residual_jac(_t(pi), _t(pj), _t(meas))
    _close(got[0], want[0], 1e-5, 1e-6)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-4, 1e-6)
    _close(tf.pre_se2_residual(_t(pi), _t(pj), _t(meas)),
           jax.vmap(jf.pre_se2_residual)(pi, pj, meas), 1e-5, 1e-6)


def _case_compose_preintegration(rng):
    ma, mb = (rng.normal(0, 0.3, (B, 3)).astype(np.float32) for _ in range(2))
    La, Lb = (rng.normal(0, 0.1, (B, 3, 3)).astype(np.float32) for _ in range(2))
    ca, cb = La @ np.swapaxes(La, 1, 2), Lb @ np.swapaxes(Lb, 1, 2)
    want = jax.vmap(jf.compose_preintegration)(ma, ca, mb, cb)
    got = tf.compose_preintegration(_t(ma), _t(ca), _t(mb), _t(cb))
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-7)


def _case_xyz_info(rng):
    jT, _ = _tcb()
    from se2lam_tpu.mapstate import kf_Tcw
    p1, _, _ = _random_geometry(rng)
    p2 = p1 + rng.normal(0, 0.2, p1.shape).astype(np.float32)
    T1 = np.asarray(jax.vmap(lambda q: kf_Tcw(q, jT))(p1))
    T2 = np.asarray(jax.vmap(lambda q: kf_Tcw(q, jT))(p2))
    xyz1 = np.stack([rng.uniform(-1, 1, B), rng.uniform(-1, 1, B),
                     rng.uniform(2, 8, B)], -1).astype(np.float32)
    want = jax.vmap(lambda a, b, c: jf.se3_to_xyz_info(a, b, c, FX))(xyz1, T1, T2)
    got = tf.se3_to_xyz_info(_t(xyz1), _t(T1), _t(T2), FX)
    for g, w in zip(got, want):
        w = np.asarray(w)
        _close(g, w, 1e-4, 1e-4 * np.abs(w).max())


FACTOR_CASES = {
    "residual_jac": _case_residual_jac,
    "huber_rho": _case_huber,
    "pixel_jacobian": _case_pixel_jacobian,
    "sigma": _case_sigma,
    "pre_se2": _case_pre_se2,
    "compose_preintegration": _case_compose_preintegration,
    "se3_to_xyz_info": _case_xyz_info,
}


@pytest.mark.parametrize("name", list(FACTOR_CASES))
def test_factor_matches_jax(rng, name):
    FACTOR_CASES[name](rng)


def _grid_problem(seed=3, K=12, M=60, P=6):
    jcam, tcam = _cams()
    jT, tT = _tcb()
    prob, true_poses = jba.synthetic_grid_ba(np.random.default_rng(seed), K, M, P, jcam, jT)
    return prob, ba_problem_from_numpy(jax.tree.map(np.asarray, prob), "cpu"), true_poses


def test_synthetic_grid_ba_matches_jax():
    jcam, tcam = _cams()
    jT, tT = _tcb()
    want, wpose = jba.synthetic_grid_ba(np.random.default_rng(5), 10, 30, 4, jcam, jT)
    got, gpose = tba.synthetic_grid_ba(np.random.default_rng(5), 10, 30, 4, tcam, tT)
    for name, g, w in zip(tba.BAProblem._fields, got, want):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            _close(g, w, 1e-5, 1e-4) if name != "obs_uv" else _close(g, w, 0, 1e-3)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    _close(gpose, wpose, 1e-6)


@pytest.mark.parametrize("grid", [False, True], ids=["scatter", "grid"])
def test_assemble_matches_jax(grid):
    jcam, tcam = _cams()
    jT, tT = _tcb()
    jprob, tprob, _ = _grid_problem()
    P = 6 if grid else 0
    want = jba._assemble(jprob, jcam, jT, jba.BAConfig(obs_grid_p=P, accum="scatter"))
    got = tba._assemble(tprob, tcam, tT, tba.BAConfig(obs_grid_p=P))
    # both branches hand the Schur kernel the [k,a],[m,b] layout contiguous
    assert got[4].is_contiguous()
    for name, g, w in zip(("Hpp", "bp", "Hxx", "bx", "Hpx", "chi2"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        _close(g, w, 0, 1e-4 * np.abs(w).max() + 1e-6)


def test_one_solve_step_matches_jax():
    """One damped step at λ = 1e-4. The reduced system is stiff (pose-θ
    rows are orders above the point-depth rows), so the f32 solve of
    either package lands ~0.4% of the step's size away from the f64
    solve of the same system (the points' depth directions up to ~4%):
    the port is held to the f64 step, no farther from it than twice the
    JAX package is, and to JAX within three times JAX's own f32 error."""
    jcam, tcam = _cams()
    jT, tT = _tcb()
    jprob, tprob, _ = _grid_problem()
    dp_j, dx_j, chi_j = jba._solve_inner(jprob, jcam, jT, jba.BAConfig(), jnp.float32(1e-4))
    dp_t, dx_t, chi_t = tba._solve_inner(tprob, tcam, tT, tba.BAConfig(), torch.tensor(1e-4))
    p64 = tba.BAProblem(*(a.double() if a.is_floating_point() else a for a in tprob))
    cam64 = TCam(*(a.double() for a in tcam))
    dp_d, dx_d, _ = tba._solve_inner(p64, cam64, tT.double(), tba.BAConfig(),
                                     torch.tensor(1e-4, dtype=torch.float64))
    _close(chi_t, chi_j, 1e-5)
    for got, want, exact in ((dp_t, dp_j, dp_d), (dx_t, dx_j, dx_d)):
        got, want, exact = got.numpy(), np.asarray(want), exact.numpy()
        scale = np.abs(exact).max()
        jax_err = np.abs(want - exact).max()
        assert np.abs(got - exact).max() <= 2 * jax_err + 1e-6 * scale
        _close(got, want, 0, 3 * jax_err + 1e-6 * scale)


@pytest.mark.parametrize("grid", [False, True], ids=["scatter", "grid"])
def test_solve_local_ba_descends_and_matches_jax(grid):
    jcam, tcam = _cams()
    jT, tT = _tcb()
    jprob, tprob, true_poses = _grid_problem()
    P = 6 if grid else 0
    pj, xj, ij = jba.solve_local_ba(jprob, jcam, jT, jba.BAConfig(iters=10, obs_grid_p=P))
    pt, xt, it = tba.solve_local_ba(tprob, tcam, tT, tba.BAConfig(iters=10, obs_grid_p=P))
    for info in (ij, it):
        assert float(info["chi2"]) < 1e-4 * float(info["chi2_init"]), info
    _close(it["chi2_init"], ij["chi2_init"], 1e-5)
    _close(it["chi2"], ij["chi2"], 1e-3, 1e-3)
    _close(pt, pj, 0, 1e-4)
    assert int(it["iters"]) == int(ij["iters"]) == 10
    np.testing.assert_allclose(pt.numpy(), np.asarray(true_poses), atol=5e-3)


def test_early_exit_counts_iterations_as_jax():
    """With term_rel > 0 the loop stops after the first accepted step that
    gains less than term_rel; 0.9 sits far from any step's gain here (a
    threshold near one can fall either side in f32)."""
    jcam, tcam = _cams()
    jT, tT = _tcb()
    jprob, tprob, _ = _grid_problem()
    _, _, ij = jba.solve_local_ba(jprob, jcam, jT, jba.BAConfig(iters=10, term_rel=0.9))
    _, _, it = tba.solve_local_ba(tprob, tcam, tT, tba.BAConfig(iters=10, term_rel=0.9))
    assert int(it["iters"]) == int(ij["iters"]) < 10
    _close(it["chi2"], ij["chi2"], 1e-3, 1e-3)
