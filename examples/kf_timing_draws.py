"""Where the first keyframe request falls, over RANSAC draws, in the JAX
package and in the PyTorch port, on the CPU.

The main path of both packages (ORB extraction, then the tracking step)
runs over the first 20 frames of the bench world (640x480, 1000 features,
5 levels; ``SyntheticWorld(n_landmarks=500, seed=0)``, 352-pose circle of
radius 2.5 m), seeded from frame 0 with no map points and re-seeded at
every keyframe request. Only the RANSAC draws change between runs: JAX
keys ``PRNGKey(s)`` split once a frame, torch generators seeded ``s``. It
prints, per draw, the frames that asked for a keyframe, the fewest
matches of a tracked frame, and the good-parallax counts of frames 9-13,
then a summary line as JSON. Tolerances in ``chip_smoke.py`` come from it.

Usage: JAX_PLATFORMS=cpu python examples/kf_timing_draws.py [--draws 12]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES = 20


def jax_draws(n_draws):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _default_cfg
    from se2lam_tpu import tracking
    from se2lam_tpu.frontend.orb import make_extractor
    from se2lam_tpu.io.synthetic import SyntheticWorld

    cfg, oc = _default_cfg()
    extract = jax.jit(make_extractor(oc))
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:N_FRAMES]
    feats = [extract(jnp.asarray(world.render(p))) for p in gt]
    N = oc.n_slots
    step = jax.jit(lambda ts, f, o, k: tracking.track_frame(ts, f, o, k, cfg))

    def reseed(f, pose, odo):
        return tracking.init_track_state(
            f, pose, odo, 0, jnp.zeros((N, 3), jnp.float32), jnp.zeros(N, bool))

    out = []
    for s in range(n_draws):
        key = jax.random.PRNGKey(s)
        ts = reseed(feats[0], jnp.asarray(gt[0]), jnp.asarray(gt[0]))
        need, matched, prl = [], [], []
        for i in range(1, N_FRAMES):
            key, sub = jax.random.split(key)
            ts, r = step(ts, feats[i], jnp.asarray(gt[i]), sub)
            matched.append(int(r.n_matched))
            prl.append(int(ts.n_good_prl))
            if bool(r.need_kf):
                need.append(i)
                ts = reseed(ts.cur_feats, ts.cur_pose, ts.cur_odom)
        out.append(dict(draw=s, need_kf_at=need, min_matched=min(matched),
                        good_prl_9_13=prl[8:13]))
    return out


def torch_draws(n_draws):
    import torch

    from se2lam_tpu_torch import tracking
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.frontend.orb import OrbExtractor
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld

    torch.set_num_threads(4)
    cfg, oc = default_cfg()
    extract = OrbExtractor(oc, device="cpu")
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:N_FRAMES]
    feats = [extract(torch.from_numpy(world.render(p))) for p in gt]
    N = oc.n_slots
    view_mp = torch.zeros((N, 3))
    no_obs = torch.zeros(N, dtype=torch.bool)

    def reseed(f, pose, odo):
        return tracking.init_track_state(f, pose, odo, 0, view_mp, no_obs)

    out = []
    for s in range(n_draws):
        gen = torch.Generator().manual_seed(s)
        ts = reseed(feats[0], gt[0], gt[0])
        need, matched, prl = [], [], []
        for i in range(1, N_FRAMES):
            ts, r = tracking.track_frame(ts, feats[i], torch.from_numpy(gt[i]), cfg,
                                         generator=gen)
            matched.append(int(r.n_matched))
            prl.append(int(ts.n_good_prl))
            if bool(r.need_kf):
                need.append(i)
                ts = reseed(ts.cur_feats, ts.cur_pose, ts.cur_odom)
        out.append(dict(draw=s, need_kf_at=need, min_matched=min(matched),
                        good_prl_9_13=prl[8:13]))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=12)
    args = ap.parse_args()
    summary = {}
    for name, fn in (("jax", jax_draws), ("torch", torch_draws)):
        runs = fn(args.draws)
        for r in runs:
            print(name, json.dumps(r), flush=True)
        firsts = [r["need_kf_at"][0] if r["need_kf_at"] else None for r in runs]
        summary[name] = dict(
            first_need_kf={str(f): firsts.count(f) for f in sorted(set(firsts), key=str)},
            min_matched=min(r["min_matched"] for r in runs),
            min_matched_when_first_at_11=min(
                (r["min_matched"] for r, f in zip(runs, firsts) if f == 11), default=None),
        )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
