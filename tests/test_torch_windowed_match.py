"""K2's plain version and the Localizer's streamed projection matcher
against the JAX package's, on seeded numpy inputs.

- ``windowed_top2_plain`` against the dense reference of
  ``tests/test_pallas_match.py``: all four outputs equal, ties included
  (descriptors drawn from a small pool tie often).
- ``windowed_top2_plain`` against the Pallas kernel in interpret mode:
  distances equal; a column index may differ only where the two columns'
  distances tie, as the JAX package's own test allows.
- ``match_by_projection_streamed`` against the JAX package's streamed
  (interpret) and dense matchers: equal ``feat_match`` and count.

The kernel itself needs the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.frontend.matcher import hamming_matrix as jhamming
from se2lam_tpu.frontend.matcher import match_by_projection as jdense
from se2lam_tpu.frontend.orb import OrbFeatures as JFeats
from se2lam_tpu.frontend.pallas_match import match_by_projection_streamed as jstreamed
from se2lam_tpu.frontend.pallas_match import windowed_top2 as jtop2
from se2lam_tpu_torch.convert import orb_features_from_numpy
from se2lam_tpu_torch.frontend import windowed_match as wm

from test_pallas_match import dense_reference

torch.set_num_threads(2)


def _inputs(seed, N1, N2, pool=None, win_lo=30.0, win_hi=300.0):
    """Rows and columns as numpy arrays; ``pool`` draws every descriptor
    from that many distinct ones, so distances tie."""
    rng = np.random.default_rng(seed)

    def desc(n):
        if pool is None:
            return (1 - 2 * rng.integers(0, 2, (n, 256))).astype(np.int8)
        base = (1 - 2 * rng.integers(0, 2, (pool, 256))).astype(np.int8)
        return base[rng.integers(0, pool, n)]

    d1, d2 = desc(N1), desc(N2)
    v1, v2 = rng.random(N1) > 0.1, rng.random(N2) > 0.1
    d2[~v2] = 0      # invalid feature slots hold zero descriptors
    lo = rng.integers(0, 2, N1).astype(np.float32)
    return dict(
        d1=d1, pred=rng.uniform(0, 640, (N1, 2)).astype(np.float32),
        win=rng.uniform(win_lo, win_hi, N1).astype(np.float32), lo=lo, hi=lo + 2.0, v1=v1,
        d2=d2, xy2=rng.uniform(0, 640, (N2, 2)).astype(np.float32),
        oct2=rng.integers(0, 5, N2).astype(np.int32), v2=v2,
    )


_ORDER = ("d1", "pred", "win", "lo", "hi", "v1", "d2", "xy2", "oct2", "v2")


def _plain(x):
    return [t.numpy() for t in wm.windowed_top2_plain(*(torch.from_numpy(x[k]) for k in _ORDER))]


def _dense_ref(x):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    out = dense_reference(j["d1"], j["d2"], j["pred"], j["xy2"], j["oct2"], j["lo"], j["hi"],
                          j["v1"], j["v2"], j["win"])
    return [np.asarray(o) for o in out]


CASES = {
    "random_200x300": dict(seed=0, N1=200, N2=300),
    "ties_200x300": dict(seed=1, N1=200, N2=300, pool=6),
    "ties_narrow_191x97": dict(seed=2, N1=191, N2=97, pool=3, win_lo=5.0, win_hi=80.0),
    "one_candidate_rows": dict(seed=3, N1=150, N2=40, win_lo=1.0, win_hi=40.0),
    "one_by_one": dict(seed=4, N1=1, N2=1, win_lo=1e4, win_hi=1e4 + 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_dense_reference(case):
    x = _inputs(**CASES[case])
    got, want = _plain(x), _dense_ref(x)
    for name, g, w in zip(("best", "second", "argbest", "argsecond"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    if case.startswith("ties"):
        # the case does exercise ties: some row's second equals its best
        assert (got[0] == got[1]).any() and (got[0] < 1e9).any()


def test_all_gated_rows_give_the_empty_result():
    x = _inputs(5, 64, 50)
    x["win"][:] = -1.0                        # a negative window admits nothing
    best, second, a, a2 = _plain(x)
    np.testing.assert_array_equal(best, np.full(64, 1e9, np.float32))
    np.testing.assert_array_equal(second, np.full(64, 1e9, np.float32))
    assert not a.any() and not a2.any()


@pytest.mark.parametrize("case", ["random_200x300", "ties_200x300"])
def test_plain_against_pallas_interpret(case):
    x = _inputs(**CASES[case])
    got = _plain(x)
    out = jtop2(*(jnp.asarray(x[k]) for k in _ORDER), interpret=True)
    want = [np.asarray(o) for o in out]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    D = np.asarray(jhamming(jnp.asarray(x["d1"]), jnp.asarray(x["d2"])))
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        for i in np.nonzero(g != w)[0]:
            assert D[i, g[i]] == D[i, w[i]]


def test_wrapper_on_cpu_is_the_plain_version():
    x = _inputs(6, 80, 60, pool=4)
    before = wm.windowed_top2.launches
    got = wm.windowed_top2(*(torch.from_numpy(x[k]) for k in _ORDER))
    assert wm.windowed_top2.launches == before
    for g, w in zip(got, _plain(x)):
        np.testing.assert_array_equal(g.numpy(), w)


def _scene(seed, M=160, N=96):
    """``tests/test_pallas_match.py``'s scene: map descriptors observed
    again with ~8 bit flips, near their projections."""
    rng = np.random.default_rng(seed)
    mp_desc = (1 - 2 * rng.integers(0, 2, (M, 256))).astype(np.int8)
    feat_desc = mp_desc[:N].copy()
    for i in range(N):
        feat_desc[i, rng.choice(256, 8, replace=False)] *= -1
    mp_uv = rng.uniform(20, 300, (M, 2)).astype(np.float32)
    feat_xy = mp_uv[:N] + rng.normal(0, 3, (N, 2)).astype(np.float32)
    mp_oct = rng.integers(0, 3, M).astype(np.int32)
    feats = JFeats(
        xy=feat_xy, angle=np.zeros(N, np.float32), octave=mp_oct[:N].copy(),
        response=np.ones(N, np.float32), valid=rng.random(N) > 0.05,
        desc_bits=np.zeros((N, 8), np.uint32), desc_pm1=feat_desc,
    )
    return feats, mp_uv, mp_oct, mp_desc, rng.random(M) > 0.1, rng.random(N) > 0.1


@pytest.mark.parametrize("seed,level_offset", [(0, 1), (1, 2), (2, 2)])
def test_streamed_projection_match_equals_jax(seed, level_offset):
    feats, mp_uv, mp_oct, mp_desc, mp_valid, free = _scene(seed)
    jf = JFeats(*(jnp.asarray(a) for a in feats))
    jargs = (jf, jnp.asarray(mp_uv), jnp.asarray(mp_oct), jnp.asarray(mp_desc),
             jnp.asarray(mp_valid), jnp.asarray(free))
    fm_s, n_s = jstreamed(*jargs, level_offset=level_offset, interpret=True)
    fm_d, n_d = jdense(*jargs, level_offset=level_offset)
    fm, n = wm.match_by_projection_streamed(
        orb_features_from_numpy(feats, device="cpu"), torch.from_numpy(mp_uv),
        torch.from_numpy(mp_oct), torch.from_numpy(mp_desc), torch.from_numpy(mp_valid),
        torch.from_numpy(free), level_offset=level_offset)
    assert int(n) == int(n_s) == int(n_d) > 20
    np.testing.assert_array_equal(fm.numpy(), np.asarray(fm_s))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(fm_d))
