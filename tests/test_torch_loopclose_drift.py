"""The JAX package's stage-level loop tests (``tests/test_loopclose.py:104``
and ``:319``) in both packages: the same synthetic scenes, drifted
odometry and per-frame tracking keys (the port takes them as Gumbel
noise); each package's LoopCloser draws its own verification noise, so
each is held to the JAX test's own claims, not to the other package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localmap as jlm, loopclose as jlc, tracking as jtr
from se2lam_tpu.mapstate import empty_map as jempty
from se2lam_tpu.ops import se2 as jse2
from se2lam_tpu_torch import localmap as tlm, loopclose as tlc, tracking as ttr
from se2lam_tpu_torch.convert import config_from_fields, orb_features_from_numpy
from se2lam_tpu_torch.mapstate import empty_map

from test_loopclose import circle_poses
from synth_utils import feats_at, make_cfg

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tcfg(cfg):
    return config_from_fields(dataclasses.asdict(cfg))


def _drive(pkg, cfg, gt, odo, pts, bits, closer_kw, min_kfs_to_train=None):
    """The stage-level loop of ``tests/test_loopclose.py`` in either
    package; the port takes JAX's per-frame tracking keys as Gumbel noise."""
    kw = dict(closer_kw)
    if min_kfs_to_train is not None:
        kw["min_kfs_to_train"] = min_kfs_to_train
    if pkg == "jax":
        closer = jlc.LoopCloser(cfg, **kw)
        ms = jempty(cfg.cap)
        f0 = feats_at(cfg, gt[0], pts, bits)
        ms = jlm.insert_first_kf(ms, f0, jnp.asarray(odo[0]), jnp.asarray(odo[0]))
        view, mask = jlm.kf_track_seed(ms, 0)
        ts = jtr.init_track_state(f0, jnp.asarray(odo[0]), jnp.asarray(odo[0]), 0, view, mask)
    else:
        tcfg = _tcfg(cfg)
        closer = tlc.LoopCloser(tcfg, device="cpu", **kw)
        ms = empty_map(tcfg.cap, "cpu")
        f0 = orb_features_from_numpy(_np(feats_at(cfg, gt[0], pts, bits)), "cpu")
        o0 = torch.from_numpy(odo[0])
        ms = tlm.insert_first_kf(ms, f0, o0, o0)
        view, mask = tlm.kf_track_seed(ms, 0)
        ts = ttr.init_track_state(f0, o0, o0, 0, view, mask)
    kfs, kf_gt = [0], {0: gt[0]}
    for i in range(1, len(gt)):
        fj = feats_at(cfg, gt[i], pts, bits)
        if pkg == "jax":
            ts, res = jtr.track_frame(ts, fj, jnp.asarray(odo[i]), jax.random.PRNGKey(i), cfg)
            if not bool(res.need_kf):
                continue
            ms, k = jlm.add_keyframe(ms, fj, ts.cur_pose, jnp.asarray(odo[i]), ts.ref_kf_idx,
                                     ts.match_idx, ts.local_mps, ts.local_mp_valid,
                                     ts.good_prl, ts.pre_meas, ts.pre_cov, cfg)
            k = int(k)
            ms, _ = jlm.run_local_ba(ms, jnp.asarray(k), cfg)
            ms = closer.on_new_kf(ms, k)
            view, mask = jlm.kf_track_seed(ms, k)
            ts = jtr.init_track_state(fj, ms.kf_pose[k], jnp.asarray(odo[i]), k, view, mask)
        else:
            f = orb_features_from_numpy(_np(fj), "cpu")
            o = torch.from_numpy(odo[i])
            g = torch.from_numpy(np.asarray(jax.random.gumbel(
                jax.random.PRNGKey(i), (cfg.cap.ransac_trials, cfg.cap.n_features),
                jnp.float32)))
            ts, res = ttr.track_frame(ts, f, o, tcfg, gumbel=g)
            if not bool(res.need_kf):
                continue
            ms, k = tlm.add_keyframe(ms, f, ts.cur_pose, o, ts.ref_kf_idx, ts.match_idx,
                                     ts.local_mps, ts.local_mp_valid, ts.good_prl,
                                     ts.pre_meas, ts.pre_cov, tcfg)
            k = int(k)
            ms, _ = tlm.run_local_ba(ms, k, tcfg)
            ms = closer.on_new_kf(ms, k)
            view, mask = tlm.kf_track_seed(ms, k)
            ts = ttr.init_track_state(f, ms.kf_pose[k], o, k, view, mask)
        kfs.append(k)
        kf_gt[k] = gt[i]
    est = np.asarray(ms.kf_pose[kfs[-1]][:2])
    return closer, kfs, float(np.linalg.norm(est - kf_gt[kfs[-1]][:2]))


def _drifted_odo(gt, bias, sigma):
    """The odometry of the JAX tests: per-step bias plus noise (seed 5)."""
    nrng = np.random.default_rng(5)
    odo = [gt[0]]
    for i in range(1, len(gt)):
        d = np.asarray(jse2.minus(jnp.asarray(gt[i]), jnp.asarray(gt[i - 1])))
        d = d + np.asarray(bias) + nrng.normal(0, sigma).astype(np.float32)
        odo.append(np.asarray(jse2.compose(jnp.asarray(odo[-1]), jnp.asarray(d, jnp.float32)),
                              np.float32))
    return np.stack(odo)


def _ring_scene(rng, n_feats, radius):
    pts = np.stack([rng.uniform(-6, 6, n_feats), rng.uniform(-6, 6, n_feats),
                    rng.uniform(-0.5, 1.5, n_feats)], -1)
    r = np.linalg.norm(pts[:, :2], axis=1)
    pts[:, :2] *= (radius / np.maximum(r, 1e-6))[:, None]
    return pts, (rng.random((n_feats, 256)) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_full_loop_closure_reduces_drift(pkg):
    """``tests/test_loopclose.py:104`` in both packages: a drifted circle
    closes, and global BA pulls the last keyframe nearer ground truth than
    raw odometry."""
    rng = np.random.default_rng(0)
    n_feats = 96
    cfg = make_cfg(n_feats, gm_dcl_min_kfid_offset=8, gm_vcl_num_min_match_mp=10,
                   gm_vcl_num_min_match_kp=15, min_frames_between_kf=1,
                   max_frames_between_kf=3)
    pts, bits = _ring_scene(rng, n_feats, 5.0)
    gt = circle_poses(90, radius=2.0)
    odo = _drifted_odo(gt, [0.002, 0.001, 0.0015], [0.001, 0.001, 0.001])
    closer, _, err = _drive(pkg, cfg, gt, odo, pts, bits,
                            dict(n_words=64, global_ba_iters=10), min_kfs_to_train=10)
    assert closer.n_loops_closed >= 1, "no loop detected on a closed circle"
    assert err < np.linalg.norm(odo[-1][:2] - gt[-1][:2])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_loop_closes_before_kf12_with_bootstrap_vocab(pkg):
    """``tests/test_loopclose.py:319`` in both packages: with the bootstrap
    vocabulary a revisit among the first dozen keyframes closes."""
    rng = np.random.default_rng(0)
    n_feats = 192
    cfg = make_cfg(n_feats, gm_dcl_min_kfid_offset=5, gm_vcl_num_min_match_mp=8,
                   gm_vcl_num_min_match_kp=12, min_frames_between_kf=1,
                   max_frames_between_kf=2)
    pts, bits = _ring_scene(rng, n_feats, 3.0)
    gt = circle_poses(21, radius=1.0)
    odo = _drifted_odo(gt, [0.0, 0.0, 0.0], [0.002, 0.001, 0.001])
    closer, _, _ = _drive(pkg, cfg, gt, odo, pts, bits, dict(n_words=64, global_ba_iters=10))
    assert closer.n_loops_closed >= 1, "no loop closed"
    assert closer.last_loop[1] < 12, f"loop closed only at KF {closer.last_loop[1]}"
