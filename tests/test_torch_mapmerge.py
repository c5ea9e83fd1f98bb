"""The port's map merging against the JAX package's.

The JAX ``SlamSystem`` builds the two half maps of ``tests/test_mapmerge.py``
(its ``_cfg``: 160x120, 128 features, 2 levels; ``SyntheticWorld(
n_landmarks=400, room=10.0, seed=2)``, an 80-frame circle, robot A on frames
0-47 and robot B on 40-79, exact odometry, loops off) once per module, and
``convert.map_state_from_numpy`` carries them over. The port's pieces run
on them with JAX's draws: ``merge_maps``' key 42 splits into k1 (the union
vocabulary's seed rows, ``jax.random.choice``), k2 (each alignment's
RANSAC noise, ``fold_in(k2, ka*131 + kb)``) and k3 (the seam verification's).

Tolerances: ``concat_maps`` is bitwise on every field. ``transform_map``
rotates by a 2x2 product whose rounding follows the product's order: poses,
points and normals within 2e-6 (a few f32 ulps of the 10 m room).
``find_cross_pair``: the same pairs, scores within 1e-6 (an L1 sum of 512
words in another order). ``align_transform``: the same inlier count, T
within 1e-5. ``merge_maps`` end to end: the same pair, verification counts,
fused points and feature edges, the same vocabulary words (idf within 1e-6),
integer tables equal before the GBAs, consistent tables after them, and
keyframe poses within 2e-3 m (5 joint LM steps over the whole map in f32,
``tests/test_torch_loopclose.py``'s bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import mapmerge as jmm
from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.localmap import compact_map as j_compact
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch import mapmerge as tmm
from se2lam_tpu_torch.convert import config_from_fields, map_state_from_numpy
from se2lam_tpu_torch.localmap import compact_map as t_compact

from test_mapmerge import _cfg
from test_prune import check_consistency

torch.set_num_threads(2)

INT_FIELDS = ("kf_obs_mp", "kf_pre_next", "covis", "ftr_i", "ftr_j", "ftr_valid", "kf_valid",
              "mp_valid", "mp_good_prl", "mp_desc", "mp_desc_votes", "mp_main_kf",
              "mp_obs_kf", "mp_obs_feat", "mp_n_obs", "n_kf", "n_mp")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(ms):
    return map_state_from_numpy(_np(ms), "cpu")


def _gumbel(key, cfg):
    return torch.from_numpy(np.asarray(jax.random.gumbel(
        key, (cfg.cap.ransac_trials, cfg.cap.n_features), jnp.float32)))


def _seed_idx(key, ms_a, ms_b, n_words=512):
    """JAX's ``train_vocab`` seed draw over the union corpus of two
    compacted maps (``se2lam_tpu/vocab.py:101-107``)."""
    valid = jnp.concatenate([(m.kf_feat_valid & m.kf_valid[:, None]).reshape(-1)
                             for m in (ms_a, ms_b)])
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    return torch.from_numpy(np.array(jax.random.choice(
        key, valid.shape[0], shape=(n_words,), replace=True, p=p)))


@pytest.fixture(scope="module")
def maps():
    cfg = _cfg()
    world = SyntheticWorld(cfg, n_landmarks=400, room=10.0, seed=2)
    gt = np.asarray(world.circle_trajectory(80))
    out = []
    for frames in (range(0, 48), range(40, 80)):
        slam = JaxSlam(cfg, enable_loops=False)
        for i in frames:
            slam.process(world.render(gt[i]), np.asarray(gt[i], np.float32))
        out.append(slam.ms)
    ms_a, ms_b = out
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(42), 3)
    ca, cb = j_compact(ms_a)[0], j_compact(ms_b)[0]
    return dict(cfg=cfg, tcfg=config_from_fields(dataclasses.asdict(cfg)), ms_a=ms_a, ms_b=ms_b,
                ca=ca, cb=cb, k1=k1, k2=k2, k3=k3, seed_idx=_seed_idx(k1, ca, cb))


def test_transform_map_matches_jax(maps):
    T = jnp.asarray([0.8, -0.3, 0.7], jnp.float32)
    want = jmm.transform_map(maps["ms_b"], T)
    got = tmm.transform_map(_port(maps["ms_b"]), torch.from_numpy(np.asarray(T)))
    for f in ("kf_pose", "mp_pos", "mp_normal"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=2e-6, err_msg=f)
    np.testing.assert_array_equal(got.kf_odom.numpy(), np.asarray(want.kf_odom))


def test_concat_maps_bitwise(maps):
    tb = jmm.transform_map(maps["cb"], jnp.asarray([0.3, 0.2, -0.4], jnp.float32))
    want = jmm.concat_maps(maps["ca"], tb)
    got = tmm.concat_maps(_port(maps["ca"]), _port(tb))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_compaction_of_jax_maps_bitwise(maps):
    got = t_compact(_port(maps["ms_b"]))[0]
    for f in maps["cb"]._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(maps["cb"], f)), err_msg=f)


def test_find_cross_pair_with_jax_seeds(maps):
    want, jvocab = jmm.find_cross_pair(maps["ca"], maps["cb"], key=maps["k1"])
    got, tvocab = tmm.find_cross_pair(_port(maps["ca"]), _port(maps["cb"]),
                                      seed_idx=maps["seed_idx"])
    np.testing.assert_array_equal(tvocab.words.numpy(), np.asarray(jvocab.words))
    assert [p[:2] for p in got] == [p[:2] for p in want]
    np.testing.assert_allclose([p[2] for p in got], [p[2] for p in want], rtol=0, atol=1e-6)


def test_find_cross_pair_drops_masked_scores(maps):
    """Pairs whose keyframes are invalid score -inf and never appear, even
    when fewer finite scores than ``top_k`` remain."""
    ca = _port(maps["ca"])
    one = ca._replace(kf_valid=torch.arange(ca.K) < 1)
    got, _ = tmm.find_cross_pair(one, _port(maps["cb"]), seed_idx=maps["seed_idx"],
                                 top_k=int(maps["cb"].n_kf) + 3)
    assert len(got) == int(maps["cb"].n_kf)
    assert all(ka == 0 and np.isfinite(s) for ka, _, s in got)


def test_align_transform_with_jax_draws(maps):
    cfg, tcfg = maps["cfg"], maps["tcfg"]
    pairs, _ = jmm.find_cross_pair(maps["ca"], maps["cb"], key=maps["k1"])
    ka, kb, _ = pairs[0]
    key = jax.random.fold_in(maps["k2"], ka * 131 + kb)
    T_j, n_j = jmm.align_transform(maps["ca"], ka, maps["cb"], kb, cfg, key=key)
    T_t, n_t = tmm.align_transform(_port(maps["ca"]), ka, _port(maps["cb"]), kb, tcfg,
                                   gumbel=_gumbel(key, cfg))
    assert n_t == n_j and n_j >= 15
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def merged(maps):
    cfg = maps["cfg"]
    captured = {}
    orig = jmm.recompute_covis

    def spy(ms):
        captured["pre_gba"] = ms
        return orig(ms)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmm, "recompute_covis", spy)
        jms, jinfo = jmm.merge_maps(maps["ms_a"], maps["ms_b"], cfg)
    k2 = maps["k2"]
    tms, tinfo = tmm.merge_maps(
        _port(maps["ms_a"]), _port(maps["ms_b"]), maps["tcfg"], device="cpu",
        seed_idx=maps["seed_idx"],
        align_gumbel=lambda ka, kb: _gumbel(jax.random.fold_in(k2, ka * 131 + kb), cfg),
        verify_gumbel=_gumbel(maps["k3"], cfg))
    return dict(jms=jms, jinfo=jinfo, jpre=captured["pre_gba"], tms=tms, tinfo=tinfo)


def test_merge_maps_with_jax_draws(merged):
    j, t = merged["jinfo"], merged["tinfo"]
    for k in ("pair", "align_inliers", "n_kp", "n_mp_pairs", "mps_fused", "seam_edge_inliers"):
        assert t[k] == j[k], (k, t[k], j[k])
    assert t["mps_fused"] >= 1
    np.testing.assert_array_equal(t["vocab"].words.numpy(), np.asarray(j["vocab"].words))
    np.testing.assert_allclose(t["vocab"].idf.numpy(), np.asarray(j["vocab"].idf),
                               rtol=0, atol=1e-6)
    jms, tms = merged["jms"], merged["tms"]
    assert int(tms.ftr_valid.sum()) == int(jnp.sum(jms.ftr_valid))
    check_consistency(tms)
    np.testing.assert_array_equal(tms.kf_valid.numpy(), np.asarray(jms.kf_valid))
    kv = np.asarray(jms.kf_valid)
    np.testing.assert_allclose(tms.kf_pose.numpy()[kv], np.asarray(jms.kf_pose)[kv],
                               rtol=0, atol=2e-3)


def test_merge_maps_tables_before_the_gbas(merged, maps):
    """The weld itself (edge, fusion, covisibility) equals JAX's: the GBAs
    move only poses and points."""
    jpre, tms = merged["jpre"], merged["tms"]
    jcov = jmm.recompute_covis(jpre)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tms, f).numpy(), np.asarray(getattr(jcov, f)),
                                      err_msg=f)


def test_merge_maps_runs_without_gba(maps):
    ms, info = tmm.merge_maps(_port(maps["ms_a"]), _port(maps["ms_b"]), maps["tcfg"],
                              device="cpu", run_gba=False,
                              generator=torch.Generator().manual_seed(42))
    assert "gba_chi2" not in info and "joint_chi2" not in info
    check_consistency(ms)


def test_concat_requires_capacity(maps):
    ca = _port(maps["ca"])
    big = ca._replace(n_kf=torch.tensor(ca.K, dtype=torch.int32),
                      kf_valid=torch.ones(ca.K, dtype=torch.bool))
    with pytest.raises(ValueError, match="exceeds capacity"):
        tmm.concat_maps(big, ca)


def test_concat_refuses_edge_overflow(maps):
    ca = _port(maps["ca"])
    full = ca._replace(ftr_valid=torch.ones_like(ca.ftr_valid))
    with pytest.raises(ValueError, match="feature-edge table overflow"):
        tmm.concat_maps(full, full._replace(n_kf=torch.tensor(1, dtype=torch.int32),
                                            n_mp=torch.tensor(0, dtype=torch.int32)))


@pytest.mark.parametrize("field, name", [("kf_desc", "descriptor width"),
                                         ("mp_obs_kf", "obs fan-in"),
                                         ("kf_xy", "features per KF")])
def test_layout_mismatch_is_refused(maps, field, name):
    ca = _port(maps["ca"])
    x = getattr(ca, field)
    cut = x[..., :-1, :] if field == "kf_xy" else x[..., :-1]
    bad = ca._replace(**{field: cut})
    with pytest.raises(ValueError, match=name):
        tmm.concat_maps(ca, bad)


def test_no_overlap_raises(maps):
    """A map B without a live keyframe: every score is masked, so no pair
    reaches the BoW gate."""
    ca = _port(maps["ca"])
    empty_b = ca._replace(kf_valid=torch.zeros_like(ca.kf_valid))
    with pytest.raises(ValueError, match="no cross-map BoW score"):
        tmm.merge_maps(ca, empty_b, maps["tcfg"], device="cpu",
                       generator=torch.Generator().manual_seed(42))
