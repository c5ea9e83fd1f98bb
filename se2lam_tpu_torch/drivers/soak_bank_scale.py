"""Bank-scale soak of the live system (the port of the JAX package's
``examples/soak_bank_scale.py``): drives ``SlamSystem`` past 200 keyframe
insertions into a 128-slot bank, with forced pruning and compaction,
vocabulary retrains and at least 10 loop closures, then asserts that the
structural invariants hold.

Asserted at the end:
  - the forward and inverse observation tables agree
    (``check_consistency_fast``);
  - at least 10 verified loop closures and 200 keyframe insertions;
  - the loop stage pulled at most twice to the host for one keyframe;
  - feature-edge slots are not exhausted;
  - the corrected ATE is at most max(raw odometry's ATE, 0.5).

The report also counts, after each insertion (each runs one prune), the
valid keyframes whose odometry successor is slot 0: the JAX package's
``prune_redundant_kf`` writes -1 to slot 0 for each keyframe without a
successor, which the port drops, and the two agree while that count is 0.

Usage:
    python -m se2lam_tpu_torch.drivers.soak_bank_scale [--laps 14]
        [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the report they write.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .study_drift import build_cfg

SOAK_MIN_INSERTS = 200
SOAK_MIN_LOOPS = 10
SOAK_MAX_PULLS = 2
SOAK_ATE_FLOOR = 0.5


def check_consistency_fast(ms):
    """Vectorized forward <-> inverse observation-table check (raises
    AssertionError on the first broken invariant)."""
    def a(x):
        return x.detach().cpu().numpy()

    obs_kf, obs_ft, kf_obs = a(ms.mp_obs_kf), a(ms.mp_obs_feat), a(ms.kf_obs_mp)
    n_obs, mv, kv = a(ms.mp_n_obs), a(ms.mp_valid), a(ms.kf_valid)
    M, P = obs_kf.shape
    # inverse -> forward
    pidx = np.arange(P)[None, :]
    live = mv[:, None] & (pidx < n_obs[:, None])
    k = np.where(live, obs_kf, 0)
    f = np.where(live, obs_ft, 0)
    assert np.all(~live | (obs_kf >= 0)), "negative observer in live row"
    assert np.all(~live | kv[k]), "observer KF invalid"
    fwd = kf_obs[k, f]
    assert np.all(~live | (fwd == np.arange(M)[:, None])), (
        "inverse entry without matching forward pointer")
    # forward -> inverse
    ks, fs = np.nonzero((kf_obs >= 0) & kv[:, None])
    ms_ = kf_obs[ks, fs]
    assert np.all(mv[ms_]), "forward pointer to invalid MP"
    hit = (obs_kf[ms_] == ks[:, None]) & (obs_ft[ms_] == fs[:, None]) & (
        np.arange(P)[None, :] < n_obs[ms_][:, None])
    assert np.all(hit.any(axis=1)), "forward pointer not in inverse list"


def soak_cfg(noise):
    """The drift study's configuration at a keyframe every 2-4 frames:
    about 300 insertions arrive at a 128-slot bank."""
    return build_cfg(odo_noise=tuple(noise)).replace(min_frames_between_kf=2,
                                                     max_frames_between_kf=4)


def soak_scene(cfg, laps, frames_per_lap, noise):
    """(world, ground truth, odometry): ``laps`` laps alternating two radii
    (2.5 m, and 2.0 m every third lap), so that revisits close loops on
    both rings."""
    from ..io import SyntheticWorld

    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    lap_a = world.circle_trajectory(frames_per_lap, radius=2.5)
    lap_b = world.circle_trajectory(frames_per_lap, radius=2.0)
    gt = np.concatenate([lap_a if i % 3 != 2 else lap_b for i in range(laps)])
    return world, gt, world.odometry(gt, noise=tuple(noise), seed=3)


def chained_into_slot0(ms) -> int:
    """Valid keyframes whose odometry successor is slot 0."""
    return int(((ms.kf_pre_next == 0) & ms.kf_valid).sum())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", type=int, default=14)
    ap.add_argument("--frames-per-lap", type=int, default=90)
    ap.add_argument("--noise", type=float, nargs=3,
                    default=(0.006, 0.003, 0.003))
    ap.add_argument("--out", default="artifacts/torch_soak")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args, on_lap=None):
    """The soak. ``on_lap(lap, slam)`` is called after each lap's last
    frame. Returns the report (asserted, then written)."""
    from ..io import ate_se2
    from ..mapstate import MAX_FTR_EDGES
    from ..system import SlamSystem

    cfg = soak_cfg(args.noise)
    world, gt, odo = soak_scene(cfg, args.laps, args.frames_per_lap, args.noise)

    slam = SlamSystem(cfg, enable_loops=True, device=args.device)
    slam.log_ba = True
    lc = slam._loop_closer
    t0 = time.time()
    max_pulls = n_inserts = max_slot0 = 0
    for i in range(len(gt)):
        slam.process(world.render(gt[i]), odo[i])
        if len(slam.ba_log) > n_inserts:
            n_inserts = len(slam.ba_log)
            max_pulls = max(max_pulls, lc.last_kf_pulls)
            max_slot0 = max(max_slot0, chained_into_slot0(slam.ms))
        if i % 100 == 99:
            print(f"f{i + 1}/{len(gt)} kfs={slam.n_keyframes()} "
                  f"mps={slam.n_map_points()} "
                  f"loops={lc.n_loops_closed} "
                  f"inserts={n_inserts} "
                  f"kf_compactions={slam.capacity_compactions} "
                  f"mp_compactions={slam.mp_compactions} "
                  f"vocab_retrains={lc.n_vocab_trainings} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if on_lap is not None and i % args.frames_per_lap == args.frames_per_lap - 1:
            on_lap(i // args.frames_per_lap, slam)
    slam._finish_loop_pending()

    ms = slam.ms
    check_consistency_fast(ms)
    n_ftr = int(ms.ftr_valid.sum())
    live = np.asarray([p for _, p in slam.trajectory])
    corr = slam.corrected_trajectory()[:, 1:]
    ate_live, _ = ate_se2(live[:, :2], gt[: len(live), :2])
    ate_corr, _ = ate_se2(corr[:, :2], gt[: len(corr), :2])
    ate_odo, _ = ate_se2(odo[:, :2], gt[:, :2])

    report = {
        "frames": int(len(gt)),
        "kf_insertions": int(n_inserts),
        "final_kfs": int(slam.n_keyframes()),
        "final_mps": int(slam.n_map_points()),
        "loops_closed": int(lc.n_loops_closed),
        "renewal_gbas": int(lc.n_renewal_gbas),
        "vocab_trainings": int(lc.n_vocab_trainings),
        "kf_compactions": int(slam.capacity_compactions),
        "mp_compactions": int(slam.mp_compactions),
        "max_loop_stage_pulls_per_kf": int(max_pulls),
        "max_kfs_chained_into_slot0": int(max_slot0),
        "ftr_edges_used": n_ftr,
        "ftr_edges_cap": int(MAX_FTR_EDGES),
        "ate_live": round(float(ate_live), 4),
        "ate_corrected": round(float(ate_corr), 4),
        "ate_odo": round(float(ate_odo), 4),
        "wall_s": round(time.time() - t0, 1),
        "consistency": "ok",
    }
    print(json.dumps(report, indent=1), flush=True)

    assert n_inserts >= SOAK_MIN_INSERTS, f"only {n_inserts} KF insertions"
    assert lc.n_loops_closed >= SOAK_MIN_LOOPS, f"only {lc.n_loops_closed} closures"
    assert max_pulls <= SOAK_MAX_PULLS, f"loop stage pulled {max_pulls}x for one KF"
    assert n_ftr < MAX_FTR_EDGES, "ftr-edge slots exhausted"
    assert ate_corr <= max(ate_odo, SOAK_ATE_FLOOR), (
        f"corrected ATE {ate_corr} unbounded vs odo {ate_odo}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "soak.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"SOAK OK -> {args.out}/soak.json")
    return report


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
