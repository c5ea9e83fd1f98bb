"""The port's mapping stage against the JAX package's, on the JAX
package's own map state.

The JAX ``SlamSystem`` (loops off) runs 31 frames of the
``tests/test_system.py`` lap at 320x240 / 256 features / 2 levels, and the
inputs of its last keyframe insertion (the map just before it, the
frame's features, the tracking state) are recorded; ``convert.py``
carries them across. Both packages then run each mapping step from the
same state.

Tolerances: integer tables (observation lists, slots, masks, window
indices) are equal: no point in this state sits on a depth or parallax
gate. Floats are within 1e-5 relative of the JAX value (plus 1e-6 of the
field's largest finite magnitude, for entries near zero). After local BA,
chi2 agrees within 1e-4 relative and keyframe poses within 1e-4; map
points within 5e-3 of the largest coordinate, 95% of them within 1e-4: a
two-observation, low-parallax point is nearly free along its viewing ray,
so f32 summation order moves it there, as it moves the JAX solve between
backends.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localmap as jlm
from se2lam_tpu.config import Capacity
from se2lam_tpu.frontend.orb import OrbConfig
from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.mapstate import empty_map as jempty
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch import localmap as tlm
from se2lam_tpu_torch.convert import (
    config_from_fields, map_state_from_numpy, orb_features_from_numpy,
)
from se2lam_tpu_torch.mapstate import MapState, empty_map

from test_prune import check_consistency, dense_map
from test_system import small_cfg

torch.set_num_threads(2)


def lap_cfg():
    cfg0 = small_cfg(256)
    oc = OrbConfig(height=cfg0.height, width=cfg0.width, n_features=256,
                   scale_factor=cfg0.scale_factor, n_levels=cfg0.max_level)
    return cfg0.replace(cap=Capacity(
        n_features=oc.n_slots, max_kfs=32, max_mps=2048,
        local_kfs=8, local_ref_kfs=8, local_mps=512, ransac_trials=64))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def captured():
    """(jax cfg, port cfg, inputs of the last insertion in 31 frames)."""
    cfg = lap_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    calls = []
    orig = jlm.insert_and_optimize

    def record(*args, **kw):
        calls.append(_np(args[:12]))
        return orig(*args, **kw)

    jlm.insert_and_optimize = record
    try:
        slam = JaxSlam(cfg, enable_loops=False)
        for img, odo in world.sequence(40, noise=(0.004, 0.002, 0.002)):
            slam.process(img, odo)
            if slam.frame_id == 31:
                break
    finally:
        jlm.insert_and_optimize = orig
    assert slam.kf_frame_ids[-1] == 30 and len(calls) == 9
    return cfg, config_from_fields(dataclasses.asdict(cfg)), calls[-1]


def _jax_args(args):
    return [jax.tree.map(jnp.asarray, a) for a in args]


def _port_args(args):
    ms, feats, *rest = args
    return [map_state_from_numpy(ms, "cpu"), orb_features_from_numpy(feats, "cpu")] + [
        torch.from_numpy(np.array(a)) for a in rest]


def assert_same_map(got: MapState, want):
    for name in MapState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            fin = np.isfinite(w)
            assert np.array_equal(fin, np.isfinite(g)), name
            scale = np.abs(w[fin]).max() if fin.any() else 0.0
            np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-6 * scale + 1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _after_add(captured):
    jcfg, tcfg, args = captured
    jms, k = jlm.add_keyframe(*_jax_args(args[:11]), jcfg)
    return jcfg, tcfg, jms, int(k), int(args[11])


def test_insert_first_kf_and_seed_match_jax(captured):
    jcfg, tcfg, args = captured
    feats = args[1]
    jms = jlm.insert_first_kf(jempty(jcfg.cap), jax.tree.map(jnp.asarray, feats),
                              jnp.zeros(3), jnp.asarray(args[3]))
    tms = tlm.insert_first_kf(empty_map(tcfg.cap, "cpu"), orb_features_from_numpy(feats, "cpu"),
                              torch.zeros(3), torch.from_numpy(np.array(args[3])))
    assert_same_map(tms, jms)
    for g, w in zip(tlm.kf_track_seed(tms, 0), jlm.kf_track_seed(jms, 0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_add_keyframe_matches_jax(captured):
    jcfg, tcfg, args = captured
    jms, jk = jlm.add_keyframe(*_jax_args(args[:11]), jcfg)
    tms, tk = tlm.add_keyframe(*_port_args(args[:11]), tcfg)
    assert int(tk) == int(jk) == 9
    assert int(tms.n_mp) > int(args[0].n_mp)     # the insertion minted points
    assert_same_map(tms, jms)
    check_consistency(tms)


def test_prune_matches_jax(rng):
    """Two pruning rounds on the dense map of ``tests/test_prune.py``,
    where keyframes are redundant."""
    cfg, ms, kfs = dense_map(rng)
    tcfg = config_from_fields(dataclasses.asdict(cfg))
    tms = map_state_from_numpy(_np(ms), "cpu")
    pruned = []
    for _ in range(2):
        ms, jkid = jlm.prune_redundant_kf(ms, jnp.asarray(kfs[-1]), cfg=cfg)
        tms, tkid = tlm.prune_redundant_kf(tms, int(kfs[-1]), cfg=tcfg)
        assert int(tkid) == int(jkid)
        pruned.append(int(tkid))
    assert min(pruned) >= 0, "no redundant KF in the dense map"
    assert_same_map(tms, ms)
    check_consistency(tms)


def test_prune_without_candidate_keeps_the_map(captured):
    jcfg, tcfg, jms, k, protect = _after_add(captured)
    tms = map_state_from_numpy(_np(jms), "cpu")
    jp, jkid = jlm.prune_redundant_kf(jms, k, protect=protect, cfg=jcfg)
    tp, tkid = tlm.prune_redundant_kf(tms, k, protect=protect, cfg=tcfg)
    assert int(tkid) == int(jkid) == -1
    assert_same_map(tp, jp)


def test_local_graph_masks_match_jax(captured):
    jcfg, tcfg, jms, k, _ = _after_add(captured)
    got = tlm.local_graph_masks(map_state_from_numpy(_np(jms), "cpu"), k)
    want = jlm.local_graph_masks(jms, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 3 <= int(got[0].sum()) and int(got[2].sum()) > 50


def test_build_local_ba_matches_jax(captured):
    jcfg, tcfg, jms, k, _ = _after_add(captured)
    got = tlm.build_local_ba(map_state_from_numpy(_np(jms), "cpu"), k, tcfg)
    want = jlm.build_local_ba(jms, k, jcfg)
    for name in ("win_kf", "win_mp", "kf_sel", "mp_sel"):
        sel = np.asarray(want.kf_sel if name.endswith("kf") else want.mp_sel)
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name.startswith("win"):   # slots of unselected window entries are padding
            g, w = g[sel], w[sel]
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in got.prob._fields:
        g, w = getattr(got.prob, name).numpy(), np.asarray(getattr(want.prob, name))
        if w.dtype.kind == "f":
            scale = np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * scale, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(got.prob.obs_valid.sum()) > 50


def assert_same_after_ba(tms, jms, tinfo, jinfo):
    np.testing.assert_allclose(float(tinfo["chi2_init"]), float(jinfo["chi2_init"]), rtol=1e-4)
    np.testing.assert_allclose(float(tinfo["chi2"]), float(jinfo["chi2"]), rtol=1e-4)
    assert float(tinfo["chi2"]) <= float(tinfo["chi2_init"])
    np.testing.assert_allclose(tms.kf_pose.numpy(), np.asarray(jms.kf_pose), rtol=0, atol=1e-4)
    g, w = tms.mp_pos.numpy(), np.asarray(jms.mp_pos)
    live = np.asarray(jms.mp_valid) & (np.abs(w).max(1) < 1e3)
    d = np.abs(g - w)[live].max(1)
    scale = np.abs(w[live]).max()
    assert d.max() <= 5e-3 * scale and np.quantile(d, 0.95) <= 1e-4 * scale, (d.max(), scale)
    rest = MapState._fields.index("kf_pose"), MapState._fields.index("mp_pos")
    for i, name in enumerate(MapState._fields):
        if i not in rest:
            gi, wi = getattr(tms, name).numpy(), np.asarray(getattr(jms, name))
            if wi.dtype.kind != "f":
                np.testing.assert_array_equal(gi, wi, err_msg=name)


def test_run_local_ba_matches_jax(captured):
    jcfg, tcfg, jms, k, _ = _after_add(captured)
    jb, jinfo = jlm.run_local_ba(jms, k, jcfg)
    tb, tinfo = tlm.run_local_ba(map_state_from_numpy(_np(jms), "cpu"), k, tcfg)
    assert int(tinfo["iters"]) == jcfg.local_iter
    assert_same_after_ba(tb, jb, tinfo, jinfo)


def test_insert_and_optimize_matches_jax(captured):
    jcfg, tcfg, args = captured
    jms, jk, jview, jmask, jinfo = jlm.insert_and_optimize(*_jax_args(args), jcfg)
    tms, tk, tview, tmask, tinfo = tlm.insert_and_optimize(*_port_args(args), tcfg)
    assert int(tk) == int(jk)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert_same_after_ba(tms, jms, tinfo, jinfo)
    np.testing.assert_allclose(tview.numpy(), np.asarray(jview), rtol=1e-5, atol=1e-5)
    check_consistency(tms)
