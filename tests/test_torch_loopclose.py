"""The port's loop closing against the JAX package's.

The JAX ``SlamSystem`` (loops on, its defaults) runs the 126-frame revisit
lap of ``tests/test_async_mapping.py`` (320x240, 256 features) once per
module; the inputs of its loop stage at the keyframe where the loop closes
are recorded (map, bank, vocabulary, throttle, cooldown and the stage's
PRNG key), and ``convert.py`` carries them across. The port's pieces then
run on that JAX-built map with JAX's draws: the per-candidate RANSAC noise
of ``jax.random.split(key, 5)`` (``loopclose.py:834``).

The port's ``SlamSystem(cfg)`` runs the same lap with JAX's per-frame
tracking draws (its loop closer draws its own RANSAC noise).

Tolerances: integer tables, slots, match indices and counts are equal,
except that a fresh verification may flip a correspondence lying on the
RANSAC threshold (at most 3% of the inliers). The loop constraint, on
one match set, is within 1e-4 and its information within 1e-3 of its
largest entry (compared on the reconstructed matrix after the eigenvalue
clamp). Poses after
the pose-graph GBA within 1e-4; after the joint GBA (5 LM steps over the
whole map, f32) within 2e-3 m, map points 95% within 1e-3 of the largest
coordinate. System level: equal keyframe frames up to the first closure,
both close a loop, both corrected ATEs beat odometry and differ by less
than 0.03 m (``tests/test_async_mapping.py:64``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import loopclose as jlc
from se2lam_tpu.io import SyntheticWorld, ate_se2
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch import loopclose as tlc
from se2lam_tpu_torch import vocab as tvoc
from se2lam_tpu_torch.convert import (
    config_from_fields, loop_closer_from_numpy, map_state_from_numpy, vocabulary_from_numpy,
)
from se2lam_tpu_torch.mapstate import MapState
from se2lam_tpu_torch.system import SlamSystem

from jax_draws import run_jax_slam, stage_gumbel
from test_dist_system import _world_cfg

torch.set_num_threads(2)

INT_FIELDS = ("kf_obs_mp", "kf_pre_next", "covis", "ftr_i", "ftr_j", "ftr_valid", "kf_valid",
              "mp_valid", "mp_good_prl", "mp_desc", "mp_desc_votes", "mp_main_kf",
              "mp_obs_kf", "mp_obs_feat", "mp_n_obs", "n_kf", "n_mp")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_ms(ms):
    return map_state_from_numpy(_np(ms), "cpu")


def _tcfg(cfg):
    return config_from_fields(dataclasses.asdict(cfg))


def _assert_tables_equal(tms: MapState, jms, fields=INT_FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(tms, f).numpy(), np.asarray(getattr(jms, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def lap():
    """Both packages on the revisit lap; JAX's stage inputs at its first
    closure."""
    cfg = _world_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    base = world.circle_trajectory(90)
    gt = np.concatenate([base, base])[:126]
    odo = world.odometry(gt, noise=(0.012, 0.006, 0.006), seed=3)
    imgs = [world.render(g) for g in gt]

    closures, pre = [], {}
    orig_stage, orig_fused = jlc.loop_stage, jlc.LoopCloser.on_new_kf_fused

    def fused(self, ms, k):
        pre.update(n_inserts=self._n_inserts, trained_at=self._trained_at_nkf)
        return orig_fused(self, ms, k)

    def stage(ms, k, bank, vocab, last_loop, cooldown, key, cfg_, **kw):
        out = orig_stage(ms, k, bank, vocab, last_loop, cooldown, key, cfg_, **kw)
        if not closures and bool(out[2]["fired"]):
            closures.append(dict(ms=ms, k=int(k), bank=bank, vocab=vocab,
                                 last_loop=np.asarray(last_loop), cooldown=bool(cooldown),
                                 key=key, kw=kw, out=out, **pre))
        return out

    js = JaxSlam(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc, "loop_stage", stage)
        mp.setattr(jlc.LoopCloser, "on_new_kf_fused", fused)
        noise = run_jax_slam(js, list(zip(imgs, odo)))
    ts = SlamSystem(_tcfg(cfg), device="cpu")
    for img, o, g in zip(imgs, odo, noise):
        ts.process(img, o, gumbel=g)
    assert closures, "the JAX package closed no loop on the lap"
    return dict(cfg=cfg, tcfg=_tcfg(cfg), gt=gt, odo=odo, js=js, ts=ts, rec=closures[0])


def test_lap_through_slam_system_matches_jax(lap):
    js, ts, gt = lap["js"], lap["ts"], lap["gt"]
    jl, tl = js._loop_closer, ts._loop_closer
    assert jl.n_loops_closed >= 1 and tl.n_loops_closed >= 1
    first = lap["rec"]["k"]
    assert ts.kf_frame_ids[: first + 1] == js.kf_frame_ids[: first + 1]
    ate_o = ate_se2(lap["odo"][:, :2], gt[:, :2])[0]
    ates = {}
    for name, s in (("jax", js), ("port", ts)):
        corr = s.corrected_trajectory()
        assert np.isfinite(corr).all()
        ates[name] = ate_se2(corr[:, 1:3], gt[: len(corr), :2])[0]
        assert ates[name] < ate_o, (name, ates, ate_o)
    assert abs(ates["jax"] - ates["port"]) < 0.03, ates
    assert tl.n_vocab_trainings == jl.n_vocab_trainings


def _closure_inputs(lap):
    r = lap["rec"]
    return r, _port_ms(r["ms"]), lap["tcfg"]


def test_select_feat_pairs_and_bow_detect_match_jax(lap):
    r, tms, tcfg = _closure_inputs(lap)
    k = r["k"]
    np.testing.assert_array_equal(tlc.select_feat_pairs(tms, k).numpy(),
                                  np.asarray(jlc.select_feat_pairs(r["ms"], k)))
    from se2lam_tpu import vocab as jvocab
    from se2lam_tpu.parallel.dist_loop import sharded_bow_detect

    jv, _ = jvocab.bow_transform(r["vocab"], r["ms"].kf_desc[k], r["ms"].kf_feat_valid[k])
    jbank = r["bank"].at[k].set(jv)
    elig = r["ms"].kf_valid & (jnp.arange(r["ms"].K) <= k - lap["cfg"].gm_dcl_min_kfid_offset)
    ji, js_ = sharded_bow_detect(jbank, jv, elig)
    tvocab = vocabulary_from_numpy(_np(r["vocab"]), "cpu")
    tv, _ = tvoc.bow_transform(tvocab, tms.kf_desc[k], tms.kf_feat_valid[k])
    ti, ts_ = tlc.bow_detect(torch.from_numpy(np.asarray(jbank)), tv,
                             torch.from_numpy(np.asarray(elig)))
    assert int(ti) == int(ji)
    assert abs(float(ts_) - float(js_)) < 1e-5


def test_verify_and_build_batch_matches_jax(lap):
    r, tms, tcfg = _closure_inputs(lap)
    k, cfg = r["k"], lap["cfg"]
    cand = r["out"][2]["cand"]
    cands = jnp.asarray([int(cand)] * 2, jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    want = _np(jlc.verify_and_build_batch(r["ms"], k, cands, keys, cfg,
                                          n_trials=cfg.cap.ransac_trials))
    g = torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(
        kk, (cfg.cap.ransac_trials, cfg.cap.n_features), jnp.float32)) for kk in keys]))
    got = tlc.verify_and_build_batch(tms, k, torch.from_numpy(np.asarray(cands)), tcfg,
                                     cfg.cap.ransac_trials, gumbel=g)
    t_midx, t_kp, t_mp, t_cur, t_meas, t_info, t_good = (a.numpy() for a in got)
    j_midx, j_kp, j_mp, j_cur, j_meas, j_info, j_good = want
    for a, b in zip((t_midx, t_kp, t_mp, t_cur, t_meas, t_info, t_good), want):
        assert a.dtype == b.dtype and a.shape == b.shape
    # a match kept by both is the same column; RANSAC's f32 Sampson test
    # may flip a correspondence lying on its threshold, so inlier sets
    # differ in at most 3% of their size (RANSAC's own parity is ±1 inlier
    # on synthetic tracks, tests/test_torch_match_ransac.py)
    both = (t_midx >= 0) & (j_midx >= 0)
    np.testing.assert_array_equal(t_midx[both], j_midx[both])
    flips = ((t_midx >= 0) != (j_midx >= 0)).sum(1)
    slack = np.maximum(1, np.ceil(0.03 * j_kp)).astype(int)
    assert (flips <= slack).all(), (flips, j_kp)
    np.testing.assert_array_equal(t_cur, j_cur)
    for a, b in ((t_kp, j_kp), (t_mp, j_mp), (t_good, j_good)):
        assert (np.abs(a - b) <= slack).all(), (a, b)
    # the constraint itself, on JAX's matches: the same pose-only solve
    # (a flipped correspondence can move this 34-point solve by ~1 cm,
    # in JAX as in the port, so the two are compared on one match set)
    for c in range(2):
        meas, info, n_good, good = tlc.build_loop_constraint(
            tms, k, int(cand), torch.from_numpy(j_midx[c]), tcfg)
        jm, ji, jg, jgood = jlc.build_loop_constraint(r["ms"], k, int(cand),
                                                      jnp.asarray(j_midx[c]), cfg)
        np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
        assert int(n_good) == int(jg) == int(j_good[c])
        np.testing.assert_allclose(meas.numpy(), np.asarray(jm), rtol=0, atol=1e-4)
        np.testing.assert_allclose(info.numpy(), np.asarray(ji), rtol=0,
                                   atol=1e-3 * np.abs(np.asarray(ji)).max())
        np.testing.assert_allclose(np.asarray(jm), j_meas[c], rtol=0, atol=1e-6)
    assert int(want[2][0]) >= cfg.gm_vcl_num_min_match_mp     # a real closure pair


def test_add_ftr_edge_matches_jax(lap):
    r, tms, _ = _closure_inputs(lap)
    meas, info = jnp.asarray([0.1, -0.2, 0.05]), 50.0 * jnp.eye(3)
    jms = jlc.add_ftr_edge(r["ms"], 3, r["k"], meas, info)
    tms2 = tlc.add_ftr_edge(tms, 3, r["k"], torch.from_numpy(np.asarray(meas)),
                            torch.from_numpy(np.asarray(info)))
    _assert_tables_equal(tms2, jms, ("ftr_i", "ftr_j", "ftr_valid"))
    np.testing.assert_array_equal(tms2.ftr_info.numpy(), np.asarray(jms.ftr_info))
    # inactive: no write; a full bank drops, or evicts its weakest edge
    off = tlc.add_ftr_edge(tms, 3, r["k"], tms.ftr_meas[0], tms.ftr_info[0],
                           active=torch.tensor(False))
    assert torch.equal(off.ftr_valid, tms.ftr_valid)
    F = tms.ftr_valid.shape[0]
    trace = np.arange(F, dtype=np.float32) + 5.0
    full = r["ms"]._replace(ftr_valid=jnp.ones(F, bool),
                            ftr_info=jnp.asarray(trace[:, None, None] * np.eye(3), jnp.float32),
                            ftr_i=jnp.zeros(F, jnp.int32), ftr_j=jnp.ones(F, jnp.int32))
    for evict in (False, True):
        jf = jlc.add_ftr_edge(full, 7, 9, meas, info, evict_if_full=evict)
        tf = tlc.add_ftr_edge(_port_ms(full), 7, 9, torch.from_numpy(np.asarray(meas)),
                              torch.from_numpy(np.asarray(info)), evict_if_full=evict)
        _assert_tables_equal(tf, jf, ("ftr_i", "ftr_j", "ftr_valid"))
        np.testing.assert_array_equal(tf.ftr_info.numpy(), np.asarray(jf.ftr_info))


def test_merge_loop_mps_matches_jax(lap):
    """On the closure's own matches (no survivor is matched twice there,
    so every scatter has one writer); the merged map keeps the
    forward/inverse table invariant."""
    from test_prune import check_consistency

    r, tms, _ = _closure_inputs(lap)
    midx = r["out"][2]["midx"]
    cand = int(r["out"][2]["cand"])
    jms = jlc.merge_loop_mps(r["ms"], r["k"], cand, midx)
    tms2 = tlc.merge_loop_mps(tms, r["k"], cand, torch.from_numpy(np.asarray(midx)))
    _assert_tables_equal(tms2, jms)
    np.testing.assert_allclose(tms2.mp_normal.numpy(), np.asarray(jms.mp_normal), rtol=0,
                               atol=1e-6)
    assert int((tms2.mp_valid != tms.mp_valid).sum()) > 0, "nothing merged"
    check_consistency(tms2)


def test_merge_with_a_repeated_survivor_writes_a_candidate(lap):
    """Two current points fused into one survivor: the survivor's normal
    is one of the two blends (the JAX write order is unspecified), its
    votes and observation count take both."""
    r, tms, _ = _closure_inputs(lap)
    k, cand = r["k"], int(r["out"][2]["cand"])
    midx = np.asarray(r["out"][2]["midx"]).copy()
    loop_row = np.asarray(r["ms"].kf_obs_mp[cand])
    cur_row = np.asarray(r["ms"].kf_obs_mp[k])
    valid = np.asarray(r["ms"].mp_valid)
    pairs = [i for i in np.nonzero(midx >= 0)[0]
             if loop_row[i] >= 0 and cur_row[midx[i]] >= 0 and loop_row[i] != cur_row[midx[i]]
             and valid[loop_row[i]] and valid[cur_row[midx[i]]]]
    a, b = pairs[0], pairs[1]
    ms_in = tms._replace(kf_obs_mp=tms.kf_obs_mp.clone())
    ms_in.kf_obs_mp[cand, b] = int(loop_row[a])          # b's loop point is a's survivor
    out = tlc.merge_loop_mps(ms_in, k, cand, torch.from_numpy(midx))
    keep = int(loop_row[a])
    dead = [int(cur_row[midx[a]]), int(cur_row[midx[b]])]
    n_keep = int(tms.mp_n_obs[keep])
    cands = []
    for d in dead:
        blend = (tms.mp_normal[keep] * n_keep + tms.mp_normal[d] * int(tms.mp_n_obs[d]))
        cands.append((blend / blend.norm()).numpy())
    got = out.mp_normal[keep].numpy()
    assert min(np.abs(got - c).max() for c in cands) < 1e-6
    want_votes = (tms.mp_desc_votes[keep].int() + tms.mp_desc_votes[dead[0]].int()
                  + tms.mp_desc_votes[dead[1]].int())
    assert torch.equal(out.mp_desc_votes[keep].int(), want_votes)
    assert not bool(out.mp_valid[dead[0]]) and not bool(out.mp_valid[dead[1]])


def test_global_ba_matches_jax(lap):
    r, tms, tcfg = _closure_inputs(lap)
    jms, jinfo = jlc.run_global_ba(r["ms"], iters=15, huber=lap["cfg"].gm_pg_huber)
    tms2, tinfo = tlc.run_global_ba(tms, iters=15, huber=tcfg.gm_pg_huber)
    jprob, tprob = jlc.build_pose_graph(r["ms"]), tlc.build_pose_graph(tms)
    for f in jprob._fields:
        a, b = getattr(tprob, f).numpy(), np.asarray(getattr(jprob, f))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(b).max()),
                                   err_msg=f)
    np.testing.assert_allclose(tms2.kf_pose.numpy(), np.asarray(jms.kf_pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tms2.mp_pos.numpy(), np.asarray(jms.mp_pos), rtol=0, atol=1e-3)
    # both converge to ~1e-7 from chi2_init; compare on the initial scale
    assert abs(float(tinfo["chi2"]) - float(jinfo["chi2"])) < 1e-6 * float(jinfo["chi2_init"])
    np.testing.assert_allclose(float(tinfo["chi2_init"]), float(jinfo["chi2_init"]), rtol=1e-4)


def test_joint_problem_and_ba_match_jax(lap):
    r, tms, tcfg = _closure_inputs(lap)
    cfg = lap["cfg"]
    jprob, tprob = jlc._joint_problem(r["ms"], cfg), tlc._joint_problem(tms, tcfg)
    for f in ("obs_kf", "obs_mp", "obs_valid", "point_valid", "pose_valid", "pose_fixed",
              "edge_i", "edge_j", "edge_valid"):
        np.testing.assert_array_equal(getattr(tprob, f).numpy(), np.asarray(getattr(jprob, f)),
                                      err_msg=f)
    v = np.asarray(jprob.obs_valid)
    np.testing.assert_allclose(tprob.obs_info.numpy()[v], np.asarray(jprob.obs_info)[v],
                               rtol=1e-4, atol=1e-6)
    jms, jinfo = jlc.run_global_ba_joint(r["ms"], cfg, iters=cfg.gm_joint_ba_iters)
    tms2, tinfo = tlc.run_global_ba_joint(tms, tcfg, iters=tcfg.gm_joint_ba_iters)
    assert float(tinfo["chi2"]) <= float(tinfo["chi2_init"])
    np.testing.assert_allclose(float(tinfo["chi2"]), float(jinfo["chi2"]), rtol=1e-3)
    np.testing.assert_allclose(tms2.kf_pose.numpy(), np.asarray(jms.kf_pose), rtol=0, atol=2e-3)
    d = np.abs(tms2.mp_pos.numpy() - np.asarray(jms.mp_pos)).max(1)
    scale = np.abs(np.asarray(jms.mp_pos)).max()
    assert np.quantile(d, 0.95) < 1e-3 * scale


def test_global_bas_on_a_mesh_match_jax(lap):
    """The mesh path's GlobalBA (edge-sharded PCG, cg_iters = K) and joint
    GBA (map-block partitioned, 8 blocks) at the closure, against the JAX
    package's on its 8 CPU devices: the pose graph within 1e-4 of JAX's
    distributed one and 1e-3 of the port's dense one, the joint GBA with
    ``test_joint_problem_and_ba_match_jax``'s tolerances."""
    from se2lam_tpu.parallel import make_mesh as jmesh
    from se2lam_tpu_torch.parallel import make_mesh

    r, tms, tcfg = _closure_inputs(lap)
    cfg = lap["cfg"]
    mesh, jm = make_mesh(8, device="cpu"), jmesh(8)
    jms, _ = jlc.run_global_ba_dist(r["ms"], jm, iters=15, huber=cfg.gm_pg_huber)
    tms2, _ = tlc.run_global_ba_dist(tms, mesh, iters=15, huber=tcfg.gm_pg_huber)
    dense, _ = tlc.run_global_ba(tms, iters=15, huber=tcfg.gm_pg_huber)
    np.testing.assert_allclose(tms2.kf_pose.numpy(), np.asarray(jms.kf_pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tms2.kf_pose.numpy(), dense.kf_pose.numpy(), rtol=0, atol=1e-3)
    jms, jinfo = jlc.run_global_ba_joint_dist(r["ms"], cfg, jm, iters=cfg.gm_joint_ba_iters)
    tms3, tinfo = tlc.run_global_ba_joint_dist(tms, tcfg, mesh, iters=tcfg.gm_joint_ba_iters)
    assert int(tinfo["n_obs_dropped"]) == 0
    assert float(tinfo["chi2"]) <= float(tinfo["chi2_init"])
    np.testing.assert_allclose(float(tinfo["chi2"]), float(jinfo["chi2"]), rtol=1e-3)
    np.testing.assert_allclose(tms3.kf_pose.numpy(), np.asarray(jms.kf_pose), rtol=0, atol=2e-3)
    d = np.abs(tms3.mp_pos.numpy() - np.asarray(jms.mp_pos)).max(1)
    assert np.quantile(d, 0.95) < 1e-3 * np.abs(np.asarray(jms.mp_pos)).max()


def _jax_stage_noise(r, cfg):
    return stage_gumbel(r["key"], cfg.cap.ransac_trials, cfg.cap.n_features)


def test_loop_stage_matches_jax(lap):
    """The whole stage at the closing keyframe, with JAX's draws: the
    same decisions, feature edges, merge and corrected map."""
    r, tms, tcfg = _closure_inputs(lap)
    kw = r["kw"]
    jms, jbank, jout = r["out"]
    tms2, tbank, tout = tlc.loop_stage(
        tms, r["k"], torch.from_numpy(np.asarray(r["bank"])),
        vocabulary_from_numpy(_np(r["vocab"]), "cpu"), torch.from_numpy(r["last_loop"]),
        r["cooldown"], tcfg, n_trials=kw["n_trials"], gba_iters=kw["gba_iters"],
        joint_iters=kw["joint_iters"], min_between=kw["min_between"],
        have_vocab=kw["have_vocab"], gumbel=_jax_stage_noise(r, lap["cfg"]))
    assert tout["fired"] and bool(jout["fired"])
    for name in ("cand", "k", "evicted", "n_feat_edges", "renewal_gba", "cooldown"):
        assert tout[name] == type(tout[name])(np.asarray(jout[name])), name
    np.testing.assert_array_equal(tout["midx"].numpy(), np.asarray(jout["midx"]))
    np.testing.assert_array_equal(tout["last_loop"].numpy(), np.asarray(jout["last_loop"]))
    np.testing.assert_allclose(tbank.numpy(), np.asarray(jbank), rtol=0, atol=1e-6)
    _assert_tables_equal(tms2, jms)
    np.testing.assert_allclose(tms2.kf_pose.numpy(), np.asarray(jms.kf_pose), rtol=0, atol=2e-3)
    # a map on which JAX wrote a loop edge carries it across bitwise
    conv = _port_ms(jms)
    assert int(conv.ftr_valid.sum()) >= 1
    for f in ("ftr_i", "ftr_j", "ftr_meas", "ftr_info", "ftr_valid"):
        np.testing.assert_array_equal(getattr(conv, f).numpy(), np.asarray(getattr(jms, f)))


def test_loop_closer_state_import_and_stage(lap):
    """A port LoopCloser in the JAX closer's state (``convert``), driven
    at the closing keyframe with JAX's draws: the counters, the throttle,
    the cooldown and the bank as JAX's after the same keyframe."""
    r, tms, tcfg = _closure_inputs(lap)
    kw = r["kw"]
    lc = loop_closer_from_numpy(
        tcfg, vocab=_np(r["vocab"]), bank=np.asarray(r["bank"]),
        last_loop=None if r["last_loop"][1] < 0 else r["last_loop"], cooldown=r["cooldown"],
        n_inserts=r["n_inserts"], trained_at_nkf=r["trained_at"],
        global_ba_iters=kw["gba_iters"], device="cpu")
    # no retraining at this insertion, so the stage's key is all it draws
    assert r["n_inserts"] + 1 < r["trained_at"] * lc.retrain_factor
    lc.stage_gumbel = lambda: _jax_stage_noise(r, lap["cfg"])
    tms2 = lc.on_new_kf(tms, r["k"])
    jms, jbank, jout = r["out"]
    assert lc.n_loops_closed == 1 and lc.last_loop == (int(jout["cand"]), r["k"])
    assert lc.n_renewal_gbas == 0 and lc._gba_cooldown
    np.testing.assert_array_equal(lc._last_loop_dev.numpy(), np.asarray(jout["last_loop"]))
    np.testing.assert_allclose(lc.bank.numpy(), np.asarray(jbank), rtol=0, atol=1e-6)
    _assert_tables_equal(tms2, jms)


def _stage_inputs(lap, dead):
    """The stage's inputs at the closing keyframe, or (``dead``) at the
    newest keyframe up to it with no feature-pair partner, throttled so
    that it has no loop candidate either: no slot to verify."""
    r, tms, tcfg = _closure_inputs(lap)
    k, last_loop = r["k"], torch.from_numpy(r["last_loop"])
    if dead:
        k = max(j for j in range(k + 1) if bool(tms.kf_valid[j])
                and bool((tlc.select_feat_pairs(tms, j) < 0).all()))
        last_loop = torch.tensor([0, k], dtype=torch.int32)
    return r, tms, tcfg, k, last_loop


@pytest.mark.parametrize("noise", ["gumbel", "generator"])
@pytest.mark.parametrize("dead", [False, True], ids=["closing", "no_live_slot"])
def test_loop_stage_verifies_only_live_slots(lap, monkeypatch, dead, noise):
    """``loop_stage`` verifies only the slots that hold a candidate, and
    returns what it returns when every slot is verified (the same call with
    the live list ignored): the same map, bank, decisions and generator
    state, bitwise; the match indices, read only after a closure, are the
    loop slot's where it is live and -1 where it is not."""
    from se2lam_tpu_torch.utils import timing

    r, tms, tcfg, k, last_loop = _stage_inputs(lap, dead)
    kw = r["kw"]
    gumbel = _jax_stage_noise(r, lap["cfg"])
    orig_batch, orig_verify = tlc.verify_and_build_batch, tlc.verify_loop
    calls = []

    def counted_verify(*a, **kw_):
        calls.append(1)
        return orig_verify(*a, **kw_)

    monkeypatch.setattr(tlc, "verify_loop", counted_verify)

    def run():
        gen = torch.Generator().manual_seed(23)
        draws = dict(gumbel=gumbel) if noise == "gumbel" else dict(generator=gen)
        calls.clear()
        timing.RECORDER.reset()
        with timing.tracing() as rec:
            out = tlc.loop_stage(
                tms, k, torch.from_numpy(np.asarray(r["bank"])),
                vocabulary_from_numpy(_np(r["vocab"]), "cpu"), last_loop, r["cooldown"], tcfg,
                n_trials=kw["n_trials"], gba_iters=kw["gba_iters"],
                joint_iters=kw["joint_iters"], min_between=kw["min_between"],
                have_vocab=kw["have_vocab"], **draws)
        (verify,) = rec.records("loop.verify")
        (detect,) = rec.records("loop.detect")
        return out, gen.get_state(), len(calls), verify.counts["live"], detect.counts["verified"]

    (ms_cut, bank_cut, out_cut), state_cut, n_cut, live, verified = run()
    monkeypatch.setattr(tlc, "verify_and_build_batch",
                        lambda *a, live=None, **kw_: orig_batch(*a, **kw_))
    (ms_all, bank_all, out_all), state_all, n_all, live_all, _ = run()

    n_live = int((tlc.select_feat_pairs(tms, k) >= 0).sum()) + int(out_all["cand"] >= 0)
    assert n_cut == live == verified == n_live and n_all == live_all == 5
    if dead:
        assert n_live == 0 and not out_all["fired"]
    else:
        assert n_live >= 1 and out_all["cand"] >= 0
        assert out_all["fired"] or noise == "generator"    # JAX's draws close the loop
    for f in MapState._fields:
        assert torch.equal(getattr(ms_cut, f), getattr(ms_all, f)), f
    assert torch.equal(bank_cut, bank_all)
    assert torch.equal(state_cut, state_all)
    assert out_cut.keys() == out_all.keys()
    for name, v in out_all.items():
        if name == "midx":
            want = v if out_all["cand"] >= 0 else torch.full_like(v, -1)
            assert torch.equal(out_cut[name], want)
        elif torch.is_tensor(v):
            assert torch.equal(out_cut[name], v), name
        else:
            assert out_cut[name] == v, name


def test_n_words_rule_and_warning():
    cfg = _tcfg(_world_cfg())
    assert tlc.LoopCloser(cfg, device="cpu").n_words == 1024
    big = cfg.replace(cap=dataclasses.replace(cfg.cap, max_kfs=2048))
    assert tlc.LoopCloser(big, device="cpu").n_words == 8192
    with pytest.warns(UserWarning, match="vocabulary width"):
        tlc.LoopCloser(cfg, n_words=64, device="cpu")
