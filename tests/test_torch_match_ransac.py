"""The port's matchers and fundamental RANSAC against the JAX package's.

The matchers get JAX's own features, carried across by ``convert.py``, and
must give equal indices: Hamming distances of ±1 descriptors are exact in
both, and ties break the same way (lowest column, lowest row). RANSAC gets
JAX's Gumbel noise, so both draw the same samples; on a clean two-view
scene the inlier sets are the same. A statistical test drives the port's
own generator, as tests/test_ransac.py drives JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _default_cfg
from se2lam_tpu.frontend import matcher as jm, ransac as jr
from se2lam_tpu.frontend.orb import make_extractor
from se2lam_tpu.io.synthetic import SyntheticWorld
from se2lam_tpu_torch.convert import orb_features_from_numpy
from se2lam_tpu_torch.frontend import matcher as tm, ransac as tr, windowed_match as wm

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    """JAX features of frames 0 and 3 of the bench world at 320x240, as
    numpy (for JAX) and as the port's tensors."""
    cfg, oc = _default_cfg(width=320, height=240, n_features=300, n_levels=3)
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)
    ext = jax.jit(make_extractor(oc))
    fj = [jax.tree.map(np.asarray, ext(jnp.asarray(world.render(gt[i])))) for i in (0, 3)]
    ft = [orb_features_from_numpy(f, "cpu") for f in fj]
    return fj, ft


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hamming_matrix(frames):
    (a, b), (ta, tb) = frames
    _eq(tm.hamming_matrix(ta.desc_pm1, tb.desc_pm1), jm.hamming_matrix(a.desc_pm1, b.desc_pm1))


@pytest.mark.parametrize("win,ratio", [(20.0, 0.9), (8.0, 0.9), (40.0, 0.7)])
def test_match_by_window(frames, win, ratio):
    (a, b), (ta, tb) = frames
    want = jm.match_by_window(a, b, a.xy, win_size=win, nn_ratio=ratio)
    got = tm.match_by_window(ta, tb, ta.xy, win_size=win, nn_ratio=ratio)
    assert int(want.n) > 5
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("ratio,rot", [(1.0, True), (0.8, True), (1.0, False)])
def test_mutual_match(frames, ratio, rot):
    (a, b), (ta, tb) = frames
    want = jm.mutual_match(a, b, nn_ratio=ratio, check_rotation=rot)
    got = tm.mutual_match(ta, tb, nn_ratio=ratio, check_rotation=rot)
    assert int(want.n) > 20
    for g, w in zip(got, want):
        _eq(g, w)


def test_match_by_projection(frames):
    """Frame-0 features stand in for map points, projected with a few px of
    noise, against frame 3's features, some of them already taken."""
    (a, b), (ta, tb) = frames
    rng = np.random.default_rng(5)
    uv = (a.xy + rng.normal(0, 2.0, a.xy.shape)).astype(np.float32)
    mp_valid = a.valid & (rng.uniform(size=a.valid.shape) > 0.1)
    free = rng.uniform(size=b.valid.shape) > 0.2
    want = jm.match_by_projection(b, uv, a.octave, a.desc_pm1, mp_valid, free)
    got = wm.match_by_projection_streamed(tb, torch.from_numpy(uv), ta.octave, ta.desc_pm1,
                                          torch.from_numpy(mp_valid), torch.from_numpy(free))
    assert int(want[1]) > 20
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def two_view_scene(rng, n=200, outlier_frac=0.3):
    """Pixels of random 3-D points in two views, with some correspondences
    moved 30-120 px off (the outliers)."""
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 12, n)], -1)
    c, s = np.cos(0.08), np.sin(0.08)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    p2 = pts @ R.T + [-0.5, 0.05, 0.1]

    def project(p):
        return p[:, :2] / p[:, 2:] * 420.0 + [320.0, 240.0]

    uv1, uv2 = project(pts), project(p2)
    out = rng.choice(n, int(n * outlier_frac), replace=False)
    uv2[out] += rng.uniform(30, 120, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    is_out = np.zeros(n, bool)
    is_out[out] = True
    return uv1.astype(np.float32), uv2.astype(np.float32), is_out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_with_jax_noise(seed):
    rng = np.random.default_rng(seed)
    uv1, uv2, _ = two_view_scene(rng)
    valid = rng.uniform(size=len(uv1)) > 0.1
    key = jax.random.PRNGKey(seed)
    want = jr.ransac_fundamental(key, jnp.asarray(uv1), jnp.asarray(uv2),
                                 jnp.asarray(valid), n_trials=128)
    g = np.array(jax.random.gumbel(key, (128, len(uv1)), jnp.float32))
    got = tr.ransac_fundamental(torch.from_numpy(uv1), torch.from_numpy(uv2),
                                torch.from_numpy(valid), n_trials=128,
                                gumbel=torch.from_numpy(g))
    _eq(got.inliers, want.inliers)
    _eq(got.n_inliers, want.n_inliers)
    assert got.n_inliers.dtype == torch.int32
    # F itself is not compared: many trials reach the same inlier set, and
    # f32 inverse iteration on near-singular 9x9 systems moves the count of
    # a trial by one now and then, so the first best trial may differ.
    # The port's model must fit the inliers as well as the threshold says.
    inl = want.inliers
    d2 = np.asarray(jr._sampson(jnp.asarray(got.F.numpy()), uv1[inl], uv2[inl]))
    assert np.quantile(d2, 0.95) < 3.0 ** 2


def test_ransac_separates_inliers_with_generator():
    rng = np.random.default_rng(0)
    uv1, uv2, is_out = two_view_scene(rng)
    res = tr.ransac_fundamental(
        torch.from_numpy(uv1), torch.from_numpy(uv2), torch.ones(len(uv1), dtype=torch.bool),
        generator=torch.Generator().manual_seed(0))
    inl = res.inliers.numpy()
    assert inl[~is_out].mean() > 0.9
    assert inl[is_out].mean() < 0.05
    assert int(res.n_inliers) > 100


def test_ransac_discards_all_when_degenerate():
    rng = np.random.default_rng(0)
    uv1 = torch.from_numpy(rng.uniform(0, 640, (40, 2)).astype(np.float32))
    uv2 = torch.from_numpy(rng.uniform(0, 640, (40, 2)).astype(np.float32))
    res = tr.ransac_fundamental(uv1, uv2, torch.ones(40, dtype=torch.bool), min_inliers=35,
                                generator=torch.Generator().manual_seed(1))
    assert int(res.n_inliers) == 0 and not bool(res.inliers.any())


def test_ransac_respects_valid_mask():
    rng = np.random.default_rng(0)
    uv1, uv2, _ = two_view_scene(rng, n=100, outlier_frac=0.0)
    valid = torch.from_numpy(rng.uniform(size=100) > 0.5)
    res = tr.ransac_fundamental(torch.from_numpy(uv1), torch.from_numpy(uv2), valid,
                                generator=torch.Generator().manual_seed(2))
    assert not bool((res.inliers & ~valid).any())
    assert int(res.n_inliers) > 30


def test_ransac_takes_exactly_one_noise_source():
    pts = torch.zeros((16, 2))
    valid = torch.ones(16, dtype=torch.bool)
    with pytest.raises(ValueError, match="exactly one"):
        tr.ransac_fundamental(pts, pts, valid)
    with pytest.raises(ValueError, match="exactly one"):
        tr.ransac_fundamental(pts, pts, valid, generator=torch.Generator(),
                              gumbel=torch.zeros((256, 16)))
    with pytest.raises(ValueError, match="gumbel shape"):
        tr.ransac_fundamental(pts, pts, valid, gumbel=torch.zeros((8, 16)))
