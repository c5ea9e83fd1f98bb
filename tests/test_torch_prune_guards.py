"""The port's pruning guards and majority descriptor votes against the JAX
package's, as ``tests/test_prune.py`` and ``tests/test_desc_votes.py`` run
them.

The pruning tests take the dense map of ``tests/test_prune.py`` (17 frames
of slow forward motion, a keyframe every frame), built once by the JAX
package and carried across with ``map_state_from_numpy``; each edit of the
JAX tests (culled points with stale inverse rows, a feature edge pinned on
the prunable keyframe, a full observation list) is made on it, and both
packages prune or append on the same map. The vote tests drive both
packages' tracking and keyframe insertion over the same synthetic
features (``jax_draws.drive_both``: frame i draws from ``PRNGKey(i)``).
A full feature bank evicting its weakest edge is held by
``tests/test_torch_loopclose.py``.

Tolerance: none on tables, slots and votes (bitwise equal); floats as
``test_torch_localmap.assert_same_map`` (1e-5 relative). Each JAX test's
own asserts are also made on the port's result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localmap as jlm
from se2lam_tpu_torch import localmap as tlm
from se2lam_tpu_torch.convert import config_from_fields, map_state_from_numpy

from jax_draws import drive_both
from synth_utils import feats_at, make_cfg, make_scene
from test_localmap import motion_poses
from test_prune import check_consistency, dense_map
from test_torch_localmap import assert_same_map

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dense():
    cfg, ms, kfs = dense_map(np.random.default_rng(0))
    return cfg, config_from_fields(dataclasses.asdict(cfg)), ms, kfs


def _port(ms):
    return map_state_from_numpy(jax.tree.map(np.asarray, ms), "cpu")


def _prune_both(dense, ms, **kw):
    """Both packages' ``prune_redundant_kf`` on the JAX map ``ms``: the same
    keyframe pruned and the same map out. Returns (port map, keyframe)."""
    cfg, tcfg, _, kfs = dense
    jms, jkid = jlm.prune_redundant_kf(ms, jnp.asarray(kfs[-1]), cfg=cfg, **kw)
    tms, tkid = tlm.prune_redundant_kf(_port(ms), int(kfs[-1]), cfg=tcfg, **kw)
    assert int(tkid) == int(jkid)
    assert_same_map(tms, jms)
    return tms, int(tkid)


def test_prune_ignores_culled_points_stale_inverse_rows(dense):
    """``tests/test_prune.py:90``: 8 survivors cut to their last two
    observers, every other point culled with its forward pointers cleared
    and its inverse rows left stale; nothing is prunable."""
    _, _, ms, _ = dense
    mv = np.asarray(ms.mp_valid)
    obs_kf = np.asarray(ms.mp_obs_kf).copy()
    obs_ft = np.asarray(ms.mp_obs_feat).copy()
    kf_obs = np.asarray(ms.kf_obs_mp).copy()
    n_obs = np.asarray(ms.mp_n_obs)
    surv = np.nonzero(mv & (n_obs >= 3))[0][:8]
    assert len(surv) >= 4
    for m in surv:
        n = int(n_obs[m])
        for p in range(0, n - 2):
            kf_obs[obs_kf[m, p], obs_ft[m, p]] = -1
        obs_kf[m, :2] = obs_kf[m, n - 2:n]
        obs_ft[m, :2] = obs_ft[m, n - 2:n]
        obs_kf[m, 2:] = -1
        obs_ft[m, 2:] = -1
    cull = mv.copy()
    cull[surv] = False
    kf_obs[(kf_obs >= 0) & cull[np.clip(kf_obs, 0, None)]] = -1
    culled = ms._replace(
        mp_valid=jnp.asarray(mv & ~cull), mp_obs_kf=jnp.asarray(obs_kf),
        mp_obs_feat=jnp.asarray(obs_ft),
        mp_n_obs=jnp.asarray(np.where(np.isin(np.arange(ms.M), surv), 2, n_obs)),
        kf_obs_mp=jnp.asarray(kf_obs))
    check_consistency(_port(culled))
    assert ((kf_obs >= 0).sum(1)[2:] > 0).any()
    _, kid = _prune_both(dense, culled)
    assert kid == -1


def test_prune_skips_ftr_edge_endpoints(dense):
    """``tests/test_prune.py:182``: a valid feature edge protects its
    endpoint, an invalid row naming it does not, and ``min_ratio=0``
    overrides the protection and drops the orphaned edge."""
    _, _, ms, _ = dense
    _, kid = _prune_both(dense, ms)
    assert kid >= 0
    ms_ftr = ms._replace(ftr_i=ms.ftr_i.at[0].set(kid), ftr_j=ms.ftr_j.at[0].set(0),
                         ftr_valid=ms.ftr_valid.at[0].set(True))
    tms2, kid2 = _prune_both(dense, ms_ftr)
    assert kid2 != kid and bool(tms2.kf_valid[kid])
    ms_stale = ms._replace(ftr_i=ms.ftr_i.at[0].set(kid), ftr_j=ms.ftr_j.at[0].set(0))
    assert _prune_both(dense, ms_stale)[1] == kid
    tms4, kid4 = _prune_both(dense, ms_ftr, min_ratio=0.0)
    assert kid4 >= 0
    if kid4 == kid:
        assert not bool(tms4.ftr_valid[0])
    check_consistency(tms4)


def test_append_obs_overflow_masked(dense):
    """``tests/test_prune.py:260``: an append to a full observation list is
    dropped and reported False; one to a non-full list lands."""
    _, _, ms, kfs = dense
    P = ms.mp_obs_kf.shape[1]
    victim = int(np.nonzero(np.asarray(ms.mp_valid))[0][0])
    ms_full = ms._replace(mp_n_obs=ms.mp_n_obs.at[victim].set(P))
    for base in (ms_full, ms):
        jms, jok = jlm._append_obs(base, jnp.asarray([victim], jnp.int32),
                                   jnp.asarray(kfs[-1]), jnp.asarray([3], jnp.int32),
                                   jnp.asarray([True]))
        tms, tok = tlm._append_obs(_port(base), torch.tensor([victim], dtype=torch.int32),
                                   torch.tensor(kfs[-1]), torch.tensor([3], dtype=torch.int32),
                                   torch.tensor([True]))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        assert_same_map(tms, jms)
        assert bool(tok[0]) == (base is ms)
    assert int(tms.mp_n_obs[victim]) == int(ms.mp_n_obs[victim]) + 1


VOTE_FIELDS = ("mp_desc", "mp_desc_votes", "mp_n_obs", "mp_valid", "mp_main_feat", "kf_obs_mp")


def _votes_both(cfg, poses, frame_feats):
    jms, tms, _ = drive_both(cfg, frame_feats, poses)
    for f in VOTE_FIELDS:
        np.testing.assert_array_equal(getattr(tms, f).numpy(), np.asarray(getattr(jms, f)),
                                      err_msg=f)
    return tms


def test_votes_track_observations():
    """``tests/test_desc_votes.py``: votes bounded by the observation
    count, the descriptor their sign, saturated on the noiseless scene."""
    cfg = make_cfg()
    pts, bits = make_scene(np.random.default_rng(0))
    poses = motion_poses(9)
    tms = _votes_both(cfg, poses, lambda i: feats_at(cfg, poses[i], pts, bits))
    mv, votes, desc, n_obs = (getattr(tms, f).numpy() for f in
                              ("mp_valid", "mp_desc_votes", "mp_desc", "mp_n_obs"))
    for m in np.nonzero(mv)[0][:30]:
        assert np.abs(votes[m]).max() <= n_obs[m]
        np.testing.assert_array_equal(desc[m], np.where(votes[m] >= 0, 1, -1))
        assert (np.abs(votes[m]) == n_obs[m]).mean() > 0.99
    np.testing.assert_allclose(np.linalg.norm(tms.mp_normal.numpy()[mv], axis=1), 1.0,
                               atol=1e-4)


def test_majority_beats_noise():
    """``tests/test_desc_votes.py``: 8% of the bits flipped a frame; the
    majority descriptor of points seen 3+ times is closer to the true one
    than a single observation."""
    cfg = make_cfg()
    pts, bits_true = make_scene(np.random.default_rng(0))
    poses = motion_poses(17)

    def noisy(i):
        flip = np.random.default_rng(1000 + i).random(bits_true.shape) < 0.08
        return np.where(flip, 1 - bits_true, bits_true).astype(np.uint8)

    tms = _votes_both(cfg, poses, lambda i: feats_at(cfg, poses[i], pts, noisy(i)))
    true_pm1 = 1 - 2 * bits_true.astype(np.int8)
    mv, desc, n_obs, feat = (getattr(tms, f).numpy() for f in
                             ("mp_valid", "mp_desc", "mp_n_obs", "mp_main_feat"))
    errs = [(desc[m] != true_pm1[feat[m]]).sum() for m in np.nonzero(mv)[0] if n_obs[m] >= 3]
    assert len(errs) > 5
    assert np.mean(errs) < 12
