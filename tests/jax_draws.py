"""The JAX package's random draws, in the form the port takes them.

Torch cannot reproduce a JAX PRNG stream, so every port function that
draws also takes the drawn samples; the parity tests capture the JAX
package's draws with these helpers and pass them in:

- ``run_jax_slam``: the JAX ``SlamSystem``'s per-frame RANSAC draws (its
  ``PRNGKey(0)``, split once per tracked frame, ``se2lam_tpu/system.py:428``)
  as the Gumbel noise of ``SlamSystem.process(..., gumbel=)``;
- ``jax_reloc_noise``: the JAX ``Localizer``'s draws (``PRNGKey(7)``, split
  once per relocalization attempt), for ``Localizer.reloc_gumbel``;
- ``stage_gumbel`` and ``jax_stage_keys``: the loop stage's per-candidate
  RANSAC noise (``se2lam_tpu/loopclose.py:834``) from the keys the JAX
  ``LoopCloser`` hands its stages, for ``LoopCloser.stage_gumbel``;
- ``drive_both``: tracking and keyframe insertion of both packages over
  given features, the frame-i RANSAC draw ``PRNGKey(i)`` as
  ``tests/test_localmap.py:drive_frames`` makes it.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localmap as jlm
from se2lam_tpu import loopclose as jlc
from se2lam_tpu import tracking as jtr
from se2lam_tpu.mapstate import empty_map as jempty
from se2lam_tpu_torch import localmap as tlm
from se2lam_tpu_torch import loopclose as tlc
from se2lam_tpu_torch import tracking as ttr
from se2lam_tpu_torch.convert import config_from_fields, orb_features_from_numpy
from se2lam_tpu_torch.mapstate import empty_map


def gumbel(key, n_trials, n_slots):
    """``jax.random.gumbel(key, (n_trials, n_slots))`` as a torch tensor:
    the draw RANSAC's Gumbel top-k takes from ``key``."""
    return torch.from_numpy(np.array(jax.random.gumbel(key, (n_trials, n_slots), jnp.float32)))


def run_jax_slam(js, frames, step=None):
    """Feed (image, odometry) pairs to the JAX ``SlamSystem`` ``js``
    (``step(img, odo)``, by default ``js.process``); returns, per frame,
    the Gumbel noise of the RANSAC draw it made, or None for a frame it
    did not track (the bootstrap, a resumed session before its
    relocalization)."""
    step = step or js.process
    T, N = js.cfg.cap.ransac_trials, js.cfg.cap.n_features
    key = jax.random.PRNGKey(0)
    out = []
    for img, odo in frames:
        tracked = js.ts is not None
        step(img, odo)
        g = None
        if tracked:
            key, sub = jax.random.split(key)
            g = gumbel(sub, T, N)
        out.append(g)
    return out


def jax_reloc_noise(n_trials, n_slots, seed=7):
    """The JAX Localizer's draws: its key split once per attempt."""
    key = [jax.random.PRNGKey(seed)]

    def nxt():
        key[0], sub = jax.random.split(key[0])
        return gumbel(sub, n_trials, n_slots)
    return nxt


def stage_gumbel(key, n_trials, n_slots):
    """The loop stage's RANSAC noise: one Gumbel draw per candidate key."""
    return torch.stack([gumbel(kk, n_trials, n_slots)
                        for kk in jax.random.split(key, tlc.N_FEAT_CANDS + 1)])


@contextlib.contextmanager
def jax_stage_keys():
    """Within it, the keys the JAX package hands ``loop_stage`` are appended
    to the yielded list, in call order."""
    keys, orig = [], jlc.loop_stage

    def stage(ms, k, bank, vocab, last_loop, cooldown, key, cfg, **kw):
        keys.append(key)
        return orig(ms, k, bank, vocab, last_loop, cooldown, key, cfg, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc, "loop_stage", stage)
        yield keys


def drive_both(cfg, frame_feats, odo):
    """Tracking and keyframe insertion (no local BA) of both packages over
    ``frame_feats(i)`` (the JAX package's ``OrbFeatures`` of frame i) and
    the odometry ``odo`` (n, 3), as ``tests/test_localmap.py:drive_frames``
    drives the JAX package: frame i draws from ``PRNGKey(i)``, the last
    frame is always a keyframe. Returns (JAX map, port map, keyframe
    slots)."""
    tcfg = config_from_fields(dataclasses.asdict(cfg))
    T, N = cfg.cap.ransac_trials, cfg.cap.n_features
    f0 = frame_feats(0)
    o0, to0 = jnp.asarray(odo[0]), torch.from_numpy(np.asarray(odo[0], np.float32))
    t0 = orb_features_from_numpy(jax.tree.map(np.asarray, f0), "cpu")
    jms = jlm.insert_first_kf(jempty(cfg.cap), f0, o0, o0)
    tms = tlm.insert_first_kf(empty_map(tcfg.cap, "cpu"), t0, to0, to0)
    jts = jtr.init_track_state(f0, o0, o0, 0, *jlm.kf_track_seed(jms, 0))
    tts = ttr.init_track_state(t0, to0, to0, 0, *tlm.kf_track_seed(tms, 0))
    kfs = [0]
    for i in range(1, len(odo)):
        f = frame_feats(i)
        tf = orb_features_from_numpy(jax.tree.map(np.asarray, f), "cpu")
        o, to = jnp.asarray(odo[i]), torch.from_numpy(np.asarray(odo[i], np.float32))
        jts, jres = jtr.track_frame(jts, f, o, jax.random.PRNGKey(i), cfg)
        tts, tres = ttr.track_frame(tts, tf, to, tcfg, gumbel=gumbel(jax.random.PRNGKey(i), T, N))
        need = bool(jres.need_kf)
        assert bool(tres.need_kf) == need, i
        if need or i == len(odo) - 1:
            jms, jk = jlm.add_keyframe(jms, f, jts.cur_pose, o, jts.ref_kf_idx, jts.match_idx,
                                       jts.local_mps, jts.local_mp_valid, jts.good_prl,
                                       jts.pre_meas, jts.pre_cov, cfg)
            tms, tk = tlm.add_keyframe(tms, tf, tts.cur_pose, to, tts.ref_kf_idx, tts.match_idx,
                                       tts.local_mps, tts.local_mp_valid, tts.good_prl,
                                       tts.pre_meas, tts.pre_cov, tcfg)
            k = int(jk)
            assert int(tk) == k, i
            kfs.append(k)
            jts = jtr.init_track_state(f, jms.kf_pose[k], o, k, *jlm.kf_track_seed(jms, k))
            tts = ttr.init_track_state(tf, tms.kf_pose[k], to, k, *tlm.kf_track_seed(tms, k))
    return jms, tms, kfs
