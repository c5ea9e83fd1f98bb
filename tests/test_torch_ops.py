"""The port's geometry ops and SE2 preintegration against the JAX
package's, on the same random batched f32 inputs made with numpy.

Tolerance: 1e-5 relative to the largest magnitude of the reference output
(f32 carries ~6e-8; the two libraries may order sums and pick sin/cos
implementations differently, which moves the last few ulps). The SO(3)
and SE(3) logs run on random rotations, on angles below 1e-6 rad and at
π, where both take the small-angle series of θ/(2 sin θ).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import se2lam_tpu.factors as jfactors
import se2lam_tpu_torch.factors as tfactors
from se2lam_tpu.ops import camera as jcam, linalg as jlin, se2 as jse2, se3 as jse3
from se2lam_tpu.ops import triangulate as jtri
from se2lam_tpu_torch.ops import camera as tcam, linalg as tlin, se2 as tse2, se3 as tse3
from se2lam_tpu_torch.ops import triangulate as ttri

torch.set_num_threads(2)

RTOL = 1e-5


def poses(rng, n=32):
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return p


def pd(rng, n, batch=16):
    a = rng.normal(size=(batch, n, n)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def rigid(rng, batch=16):
    t = rng.uniform(-1, 1, (batch, 3)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, batch)
    R = np.zeros((batch, 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1] = np.cos(th), np.sin(th), 1.0
    R[:, 2, 0], R[:, 2, 2] = -np.sin(th), np.cos(th)
    return R, t


def twists(rng, batch=16):
    """[rho, phi] twists with rotation angles in (0, 3) rad."""
    xi = rng.normal(size=(batch, 6))
    axis = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
    xi[:, 3:] = axis * rng.uniform(0.05, 3.0, (batch, 1))
    return xi.astype(np.float32)


def axis_rotations(rng, theta, batch=16):
    """Rotation matrices by angles ``theta`` about random axes, made in
    f64 (Rodrigues) and rounded to f32."""
    a = rng.normal(size=(batch, 3))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    th = np.broadcast_to(np.asarray(theta, np.float64), (batch,))[:, None, None]
    K = np.zeros((batch, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -a[:, 2], a[:, 1], -a[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    return R.astype(np.float32)


def two_views(rng, n=64):
    """Points 3-10 m ahead seen by two cameras with a 0.8 m baseline."""
    K = np.array([[420.0, 0, 320.0], [0, 400.0, 240.0], [0, 0, 1]], np.float32)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                    rng.uniform(3, 10, n)], -1).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    T2 = np.array([[c, 0, s, -0.8], [0, 1, 0, 0.1], [-s, 0, c, 0.2]], np.float32)
    uv1 = pts[:, :2] / pts[:, 2:] * [420.0, 400.0] + [320.0, 240.0]
    p2 = pts @ T2[:, :3].T + T2[:, 3]
    uv2 = p2[:, :2] / p2[:, 2:] * [420.0, 400.0] + [320.0, 240.0]
    P1 = np.broadcast_to(K @ np.eye(4, dtype=np.float32)[:3], (n, 3, 4))
    P2 = np.broadcast_to(K @ T2, (n, 3, 4))
    return [a.astype(np.float32) for a in (uv1, uv2, P1, P2)]


DIST = (-0.28, 0.07, 1e-3, -2e-4, 0.0)


def _cam(mod, dist=DIST, **kw):
    return mod.CameraModel.create(420.0, 400.0, 320.0, 240.0, dist, **kw)


# name -> (inputs from a numpy rng, f(modules, *inputs) -> output)
CASES = {
    "se2.normalize_angle": (
        lambda r: [r.uniform(-20, 20, 64).astype(np.float32)],
        lambda m, t: m["se2"].normalize_angle(t)),
    "se2.rot2": (lambda r: [poses(r)[:, 2]], lambda m, t: m["se2"].rot2(t)),
    "se2.compose": (lambda r: [poses(r), poses(r)], lambda m, a, b: m["se2"].compose(a, b)),
    "se2.inv": (lambda r: [poses(r)], lambda m, a: m["se2"].inv(a)),
    "se2.minus": (lambda r: [poses(r), poses(r)], lambda m, a, b: m["se2"].minus(a, b)),
    "se2.to_se3": (lambda r: [poses(r)], lambda m, a: m["se2"].to_se3(a)),
    "se2.from_se3": (lambda r: [poses(r)],
                     lambda m, a: m["se2"].from_se3(m["se2"].to_se3(a))),
    "se2.apply": (lambda r: [poses(r), r.normal(size=(32, 2)).astype(np.float32)],
                  lambda m, a, p: m["se2"].apply(a, p)),
    "se3.skew": (lambda r: [r.normal(size=(16, 3)).astype(np.float32)],
                 lambda m, v: m["se3"].skew(v)),
    "se3.make_rt": (lambda r: list(rigid(r)), lambda m, R, t: m["se3"].make_rt(R, t)),
    "se3.inv": (lambda r: list(rigid(r)),
                lambda m, R, t: m["se3"].inv(m["se3"].make_rt(R, t))),
    "se3.apply": (lambda r: list(rigid(r)) + [r.normal(size=(16, 3)).astype(np.float32)],
                  lambda m, R, t, p: m["se3"].apply(m["se3"].make_rt(R, t), p)),
    "se3.so3_log": (lambda r: [axis_rotations(r, r.uniform(0.01, 3.0, 16))],
                    lambda m, R: m["se3"].so3_log(R)),
    "se3.so3_log_small_angle": (lambda r: [axis_rotations(r, r.uniform(0.0, 1e-6, 16))],
                                lambda m, R: m["se3"].so3_log(R)),
    "se3.so3_log_at_pi": (lambda r: [axis_rotations(r, np.pi)],
                          lambda m, R: m["se3"].so3_log(R)),
    "se3.so3_log_of_exp": (lambda r: [twists(r)[:, 3:]],
                           lambda m, p: m["se3"].so3_log(m["se3"].so3_exp(p))),
    "se3.so3_left_jacobian": (
        lambda r: [np.concatenate([twists(r)[:, 3:], r.normal(0, 1e-5, (4, 3))]).astype(
            np.float32)],
        lambda m, p: m["se3"]._so3_left_jacobian(p)),
    "se3.se3_exp": (lambda r: [twists(r)], lambda m, xi: m["se3"].se3_exp(xi)),
    "se3.se3_exp_small_angle": (
        lambda r: [np.concatenate([r.normal(size=(16, 3)), r.normal(0, 1e-7, (16, 3))],
                                  1).astype(np.float32)],
        lambda m, xi: m["se3"].se3_exp(xi)),
    "se3.se3_log": (lambda r: list(rigid(r)),
                    lambda m, R, t: m["se3"].se3_log(m["se3"].make_rt(R, t))),
    "se3.se3_log_of_exp": (lambda r: [twists(r)],
                           lambda m, xi: m["se3"].se3_log(m["se3"].se3_exp(xi))),
    "se3.adjoint": (lambda r: list(rigid(r)),
                    lambda m, R, t: m["se3"].adjoint(m["se3"].make_rt(R, t))),
    "linalg.inv_psd_small": (lambda r: [pd(r, 9)], lambda m, M: m["lin"].inv_psd_small(M)),
    "linalg.inv2x2": (lambda r: [pd(r, 2)], lambda m, M: m["lin"].inv2x2(M)),
    "linalg.inv3x3": (lambda r: [pd(r, 3)], lambda m, M: m["lin"].inv3x3(M)),
    "camera.K": (lambda r: [], lambda m: _cam(m["cam"], **m["kw"]).K),
    "camera.project": (
        lambda r: [np.stack([r.uniform(-2, 2, 64), r.uniform(-1, 1, 64),
                             r.uniform(2, 9, 64)], -1).astype(np.float32)],
        lambda m, p: m["cam"].project(_cam(m["cam"], **m["kw"]), p)),
    "camera.distort_normalized": (
        lambda r: [r.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)],
        lambda m, xy: m["cam"].distort_normalized(_cam(m["cam"], **m["kw"]), xy)),
    "camera.undistort_points": (
        lambda r: [np.stack([r.uniform(40, 600, 64), r.uniform(40, 440, 64)],
                            -1).astype(np.float32)],
        lambda m, uv: m["cam"].undistort_points(_cam(m["cam"], **m["kw"]), uv)),
    "triangulate.triangulate": (
        two_views, lambda m, u1, u2, P1, P2: m["tri"].triangulate(u1, u2, P1, P2)),
    "triangulate.parallax_cos": (
        lambda r: [r.normal(size=3).astype(np.float32),
                   r.normal(size=(64, 3)).astype(np.float32),
                   r.uniform(-5, 5, (64, 3)).astype(np.float32)],
        lambda m, o1, o2, p: m["tri"].parallax_cos(o1, o2, p)),
    "factors.se2_to_se3_mat": (lambda r: [poses(r)],
                               lambda m, a: m["fac"].se2_to_se3_mat(a)),
    "factors.preintegrate_se2": (
        lambda r: [poses(r, 16) * 0.1, pd(r, 3) * 1e-3,
                   r.normal(0, 0.05, (16, 3)).astype(np.float32),
                   r.uniform(1e-3, 1e-2, (16, 3)).astype(np.float32)],
        lambda m, meas, cov, d, nz: m["fac"].preintegrate_se2(meas, cov, d, nz)),
}

JAX = dict(se2=jse2, se3=jse3, lin=jlin, cam=jcam, tri=jtri, fac=jfactors, kw={})
PORT = dict(se2=tse2, se3=tse3, lin=tlin, cam=tcam, tri=ttri, fac=tfactors,
            kw=dict(device="cpu"))


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_op_matches_jax(name):
    make, fn = CASES[name]
    inputs = make(np.random.default_rng(zlib.crc32(name.encode())))
    want = _flat(fn(JAX, *[jnp.asarray(a) for a in inputs]))
    got = _flat(fn(PORT, *[torch.from_numpy(np.ascontiguousarray(a)) for a in inputs]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL * scale)


def test_check_parallax_gate_matches_jax():
    rng = np.random.default_rng(3)
    o2 = rng.normal(size=3).astype(np.float32)
    pts = rng.uniform(-50, 50, (256, 3)).astype(np.float32)
    for deg in (1, 2, 3, 4):
        want = np.asarray(jtri.check_parallax(jnp.zeros(3), jnp.asarray(o2),
                                              jnp.asarray(pts), deg))
        got = ttri.check_parallax(torch.zeros(3), torch.from_numpy(o2),
                                  torch.from_numpy(pts), deg).numpy()
        np.testing.assert_array_equal(got, want)


def test_se3_exp_and_log_round_trip():
    """The port's logs invert its exps: a twist with a rotation angle in
    (0, 3) rad comes back within 1e-4 (f32, the left Jacobian's solve),
    and SE(3) matrices come back within 1e-5."""
    rng = np.random.default_rng(11)
    xi = torch.from_numpy(twists(rng, 64))
    np.testing.assert_allclose(tse3.se3_log(tse3.se3_exp(xi)).numpy(), xi.numpy(), atol=1e-4)
    np.testing.assert_allclose(tse3.so3_log(tse3.so3_exp(xi[:, 3:])).numpy(), xi[:, 3:].numpy(),
                               atol=1e-4)
    T = tse3.make_rt(*map(torch.from_numpy, rigid(rng, 64)))
    np.testing.assert_allclose(tse3.se3_exp(tse3.se3_log(T)).numpy(), T.numpy(), atol=1e-5)
    assert torch.isfinite(tse3.so3_log(torch.eye(3))).all()
