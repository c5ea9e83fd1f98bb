"""The slice as a whole: the port's tracking step (and extraction) against
the JAX package's, frame by frame, at 320x240 / 300 features / 3 levels.

Both packages draw their RANSAC samples from JAX's Gumbel noise. Tolerance,
per frame: ``pose`` within 1e-6 (it is the odometry prediction, and sin/cos
differ by an ulp between the libraries); ``need_kf`` equal; ``n_matched``
and ``n_tracked_old`` within 1 and ``match_idx`` equal in all but 2% of the
slots, where a slot may only be matched in one package and unmatched in the
other, never matched to two different features. The reason: the 8-point
solve's inverse iteration, the triangulation's normal equations and its
depth and parallax gates are ill-conditioned in f32, and the two libraries
order their sums differently, so a point that sits on a Sampson, depth or
parallax threshold can fall on either side. Such points are rare; the
pose, the keyframe decision and the matching itself are not affected.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _default_cfg
from se2lam_tpu import localmap, tracking as jt
from se2lam_tpu.frontend.orb import make_extractor
from se2lam_tpu.io.synthetic import SyntheticWorld
from se2lam_tpu.mapstate import empty_map
from se2lam_tpu_torch import tracking as tt
from se2lam_tpu_torch.convert import (
    config_from_fields, orb_features_from_numpy, track_state_from_numpy,
)
from se2lam_tpu_torch.entry import default_cfg
from se2lam_tpu_torch.frontend.orb import OrbExtractor

torch.set_num_threads(2)

SMALL = dict(width=320, height=240, n_features=300, n_levels=3)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _gumbel(key, cfg, n):
    """The noise JAX's ransac_fundamental draws from ``key``."""
    g = jax.random.gumbel(key, (cfg.cap.ransac_trials, n), jnp.float32)
    return torch.from_numpy(np.array(g))


def _assert_same_step(i, tsj, rj, tst, rt):
    want, got = np.asarray(tsj.match_idx), tst.match_idx.numpy()
    differ = want != got
    assert differ.sum() <= 0.02 * want.size, (i, np.nonzero(differ))
    assert not (differ & (want >= 0) & (got >= 0)).any(), i
    assert abs(int(rt.n_matched) - int(rj.n_matched)) <= 1, i
    assert abs(int(rt.n_tracked_old) - int(rj.n_tracked_old)) <= 1, i
    assert bool(rt.need_kf) == bool(rj.need_kf), i
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), rtol=0, atol=1e-6,
                               err_msg=f"frame {i}")
    np.testing.assert_allclose(tst.pre_cov.numpy(), np.asarray(tsj.pre_cov),
                               rtol=1e-5, atol=1e-12)


@pytest.fixture(scope="module")
def bench_world():
    """bench.py's world and trajectory at the small size: 12 warm-up frames
    and 8 more."""
    cfg, oc = _default_cfg(**SMALL)
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    n_total = 20
    gt = world.circle_trajectory(n_total * 8, radius=2.5)[:n_total]
    imgs = [world.render(p) for p in gt]
    return cfg, oc, imgs, gt


def test_steady_state_tracking_matches_jax(bench_world):
    """bench.py:140-167 at the small size: first KF, 11 tracked frames, a
    real keyframe from JAX's localmap, a re-seed on it. The state, carried
    across by convert.py, then tracks 8 frames in both packages on JAX's
    features."""
    cfg, oc, imgs, gt = bench_world
    tcfg = config_from_fields(dataclasses.asdict(cfg))
    extract = jax.jit(make_extractor(oc))
    step = jax.jit(lambda ts, f, o, k: jt.track_frame(ts, f, o, k, cfg))
    feats = [extract(jnp.asarray(im)) for im in imgs]
    odos = [jnp.asarray(p) for p in gt]
    n_seed = 12

    ms = localmap.insert_first_kf(empty_map(cfg.cap), feats[0], jnp.zeros(3), odos[0])
    view_mp, obs_mask = localmap.kf_track_seed(ms, 0)
    ts = jt.init_track_state(feats[0], jnp.zeros(3), odos[0], 0, view_mp, obs_mask)
    key = jax.random.PRNGKey(0)
    for i in range(1, n_seed):
        key, sub = jax.random.split(key)
        ts, _ = step(ts, feats[i], odos[i], sub)
    ms, k = localmap.add_keyframe(
        ms, feats[n_seed - 1], ts.cur_pose, odos[n_seed - 1], ts.ref_kf_idx,
        ts.match_idx, ts.local_mps, ts.local_mp_valid, ts.good_prl,
        ts.pre_meas, ts.pre_cov, cfg,
    )
    view_mp, obs_mask = localmap.kf_track_seed(ms, k)
    tsj = jt.init_track_state(feats[n_seed - 1], ms.kf_pose[k], odos[n_seed - 1], k,
                              view_mp, obs_mask)
    assert int(jnp.sum(obs_mask)) > 20   # the steady state has map points

    keys = jax.random.split(jax.random.PRNGKey(7), len(imgs) - n_seed)
    tracked_old = 0
    for i, sub in zip(range(n_seed, len(imgs)), keys):
        # both step from the same state: JAX's, carried across
        tst = track_state_from_numpy(_numpy(tsj), "cpu")
        assert tst.ref_feats.desc_bits.dtype == torch.uint32
        tsj, rj = step(tsj, feats[i], odos[i], sub)
        tst, rt = tt.track_frame(
            tst, orb_features_from_numpy(_numpy(feats[i]), "cpu"),
            torch.from_numpy(gt[i]), tcfg, gumbel=_gumbel(sub, cfg, oc.n_slots))
        _assert_same_step(i, tsj, rj, tst, rt)
        tracked_old += int(rt.n_tracked_old)
    assert tracked_old > 0


def test_entry_style_seed_matches_jax(bench_world):
    """Port extraction + port tracking against JAX extraction + JAX
    tracking, from an entry()-style seed (frame 0 as reference, no map
    points), re-seeding where a keyframe is asked for. Each package carries
    its own state from frame to frame."""
    cfg, oc, imgs, gt = bench_world
    tcfg, toc = default_cfg(**SMALL)
    extract = make_extractor(oc)
    step = jax.jit(lambda img, ts, o, k: jt.track_frame(ts, extract(img), o, k, cfg))
    text = OrbExtractor(toc, device="cpu")
    N = oc.n_slots

    f0 = jax.jit(extract)(jnp.asarray(imgs[0]))
    tsj = jt.init_track_state(f0, gt[0], gt[0], 0, jnp.zeros((N, 3)), jnp.zeros(N, bool))
    tst = tt.init_track_state(text(torch.from_numpy(imgs[0])), gt[0], gt[0], 0,
                              torch.zeros((N, 3)), torch.zeros(N, dtype=torch.bool))
    key = jax.random.PRNGKey(0)
    for i in range(1, 10):
        key, sub = jax.random.split(key)
        tsj, rj = step(jnp.asarray(imgs[i]), tsj, jnp.asarray(gt[i]), sub)
        tst, rt = tt.track_frame(tst, text(torch.from_numpy(imgs[i])),
                                 torch.from_numpy(gt[i]), tcfg,
                                 gumbel=_gumbel(sub, cfg, N))
        _assert_same_step(i, tsj, rj, tst, rt)
        assert int(rt.n_matched) > 50
        if bool(rj.need_kf):
            tsj = jt.init_track_state(tsj.cur_feats, tsj.cur_pose, tsj.cur_odom, 0,
                                      jnp.zeros((N, 3)), jnp.zeros(N, bool))
            tst = tt.init_track_state(tst.cur_feats, tst.cur_pose, tst.cur_odom, 0,
                                      torch.zeros((N, 3)), torch.zeros(N, dtype=torch.bool))


def test_entry_runs_one_step_on_cpu():
    from se2lam_tpu_torch.entry import entry

    step, (img, ts, odo, gen) = entry(device="cpu")
    ts2, res = step(img, ts, odo, gen)
    assert ts2.match_idx.dtype == torch.int32 and res.need_kf.dtype == torch.bool
    assert int(res.n_matched) > 100
    np.testing.assert_allclose(res.pose.numpy(), odo.numpy(), atol=1e-6)


def test_config_from_fields_round_trip():
    cfg, _ = _default_cfg()
    tcfg = config_from_fields(dataclasses.asdict(cfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    np.testing.assert_array_equal(tcfg.Tcb_mat, cfg.Tcb_mat)
    hash(tcfg)   # usable as a static value, as the JAX config is


def test_from_yaml_matches_jax(tmp_path):
    from se2lam_tpu.config import SystemConfig as JaxConfig
    from se2lam_tpu_torch.config import SystemConfig as TorchConfig
    from test_config import CAM_YML, SETTINGS_YML

    cam, st = tmp_path / "CamConfig.yml", tmp_path / "Settings.yml"
    cam.write_text(CAM_YML)
    st.write_text(SETTINGS_YML)
    want = JaxConfig.from_yaml(str(cam), str(st))
    got = TorchConfig.from_yaml(str(cam), str(st))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
