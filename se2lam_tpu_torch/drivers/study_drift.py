"""Long-horizon drift study: what loop closing and joint global BA buy
(the port of the JAX package's ``examples/study_drift.py``).

Runs one multi-lap synthetic sequence (odometry noise raised so that dead
reckoning drifts) through four estimators:

  odo          raw odometry integration (the drift floor SLAM must beat)
  slam_noloop  tracking and local mapping only (no loop detection; the
               feature edges and the renewal GlobalBA stay on)
  slam_pg      + loop closing with the pose-graph GlobalBA and the rigid
               map-point re-anchor (src/GlobalMapper.cpp:328-535)
  slam_joint   + the joint full-map pose and point BA after each closure
               (``run_global_ba_joint``)

and reports the SE(2)-aligned ATE of the live and the corrected
trajectories against ground truth, closures, keyframes and the position
error at each lap's end. Writes ``results.json`` (and, where matplotlib
is installed, ``trajectories.png``) to ``--out``.

Usage:
    python -m se2lam_tpu_torch.drivers.study_drift [--laps 3]
        [--odo-seeds 3 5 7 11] [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the results dict they write.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config import Capacity, SystemConfig
from ..frontend.orb import OrbConfig

ESTIMATORS = ("slam_noloop", "slam_pg", "slam_joint")


def build_cfg(n_feats=256, joint_iters=5, odo_noise=(0.012, 0.006, 0.006)):
    """The study's configuration: 320x240, ``n_feats`` features, 2 levels,
    128 keyframe and 8192 point slots, a local window of 8+8 keyframes and
    512 points, the loop gates scaled to the 256-feature scene.
    ``odo_noise``: the estimator's per-step odometry noise model
    (``cfg.odo_*_noise``), which must match the simulated noise (the
    reference reads it from Settings.yml, src/Config.cpp:141-153)."""
    TCB = np.array(
        [[0.0, -1.0, 0.0, 0.0],
         [0.0, 0.0, -1.0, 0.6],
         [1.0, 0.0, 0.0, 0.0],
         [0.0, 0.0, 0.0, 1.0]], dtype=np.float64)
    cfg0 = SystemConfig(
        width=320, height=240,
        fx=260.0, fy=260.0, cx=160.0, cy=120.0,
        Tbc=tuple(np.linalg.inv(TCB).ravel()),
        upper_depth=30.0, lower_depth=0.2,
        max_feature_num=n_feats, max_level=2, scale_factor=1.2,
        min_frames_between_kf=2, max_frames_between_kf=8,
        local_iter=6,
        odo_x_noise=float(odo_noise[0]),
        odo_y_noise=float(odo_noise[1]),
        odo_t_noise=float(odo_noise[2]),
        gm_joint_ba_iters=joint_iters,
        gm_dcl_min_kfid_offset=8,
        gm_vcl_num_min_match_mp=6,
        gm_vcl_num_min_match_kp=15,
    )
    oc = OrbConfig(
        height=cfg0.height, width=cfg0.width, n_features=n_feats,
        scale_factor=cfg0.scale_factor, n_levels=cfg0.max_level,
    )
    return cfg0.replace(
        cap=Capacity(
            n_features=oc.n_slots, max_kfs=128, max_mps=8192,
            local_kfs=8, local_ref_kfs=8, local_mps=512, ransac_trials=64,
        )
    )


def _rel_to_start(traj):
    """An (N, 3) SE(2) trajectory relative to its own first pose: removes
    the gauge between the map frame (anchored at the first frame) and the
    world frame without the whole-path alignment that hides tail drift."""
    x0, y0, t0 = traj[0]
    c, s = np.cos(-t0), np.sin(-t0)
    dx, dy = traj[:, 0] - x0, traj[:, 1] - y0
    out = np.stack([c * dx - s * dy, s * dx + c * dy, traj[:, 2] - t0], -1)
    out[:, 2] = np.arctan2(np.sin(out[:, 2]), np.cos(out[:, 2]))
    return out


def lap_drift(est, gt, frames_per_lap):
    """Position error at each lap's last frame (and at the last frame of a
    partial lap), both trajectories relative to their own start."""
    n = min(len(est), len(gt))
    er, gr = _rel_to_start(est[:n]), _rel_to_start(gt[:n])
    errs = []
    j = frames_per_lap - 1
    while j < n:
        errs.append(round(float(np.linalg.norm(er[j, :2] - gr[j, :2])), 4))
        j += frames_per_lap
    if (n - 1) % frames_per_lap != frames_per_lap - 1:
        errs.append(round(float(np.linalg.norm(er[n - 1, :2] - gr[n - 1, :2])), 4))
    return errs


def lap_sequence(world, laps, frames_per_lap):
    """``laps`` (a float) laps of the world's circle: (n, 3) ground truth."""
    lap = world.circle_trajectory(frames_per_lap)
    n = int(laps * frames_per_lap)
    reps = int(np.ceil(n / frames_per_lap))
    return np.concatenate([lap] * reps)[:n]


def run_slam(cfg, world, gt, odo, enable_loops, frames_per_lap, device=None,
             gumbels=None, stage_gumbel=None, on_frame=None):
    """One SLAM run over the rendered ground truth. Loop detection follows
    ``enable_loops``; the feature edges and the renewal GlobalBA stay on
    (the reference has no switch for them). ``gumbels`` (one a frame) and
    ``stage_gumbel`` replace the system's and the loop closer's own
    generators (a parity run passes the JAX package's draws);
    ``on_frame(i, slam)`` is called after each frame.
    Returns (result dict, corrected (n, 3) trajectory)."""
    from ..io import ate_se2
    from ..system import SlamSystem

    slam = SlamSystem(cfg, enable_loops=True, detect_loops=enable_loops, device=device)
    if stage_gumbel is not None:
        slam._loop_closer.stage_gumbel = stage_gumbel
    for i in range(len(gt)):
        slam.process(world.render(gt[i]), odo[i],
                     gumbel=None if gumbels is None else gumbels[i])
        if on_frame is not None:
            on_frame(i, slam)
    live = np.asarray([p for _, p in slam.trajectory])
    corr = slam.corrected_trajectory()[:, 1:]
    ate_live, _ = ate_se2(live[:, :2], gt[: len(live), :2])
    ate_corr, _ = ate_se2(corr[:, :2], gt[: len(corr), :2])
    lc = slam._loop_closer
    return {
        "ate_live": round(float(ate_live), 4),
        "ate_corrected": round(float(ate_corr), 4),
        "lap_drift": lap_drift(corr, gt, frames_per_lap),
        "n_loops": int(lc.n_loops_closed if lc else 0),
        "n_renewal_gbas": int(lc.n_renewal_gbas if lc else 0),
        "n_kfs": int(slam.n_keyframes()),
        "n_mps": int(slam.n_map_points()),
    }, corr


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", type=float, default=3.0)
    ap.add_argument("--frames-per-lap", type=int, default=90)
    ap.add_argument("--noise", type=float, nargs=3,
                    default=(0.012, 0.006, 0.006),
                    metavar=("X", "Y", "TH"))
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--odo-seeds", type=int, nargs="*", default=None,
                    help="run every estimator under each of these "
                         "odometry-noise draws (default: the single "
                         "draw seed 3)")
    ap.add_argument("--out", default="artifacts/torch_drift_study")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def _plot(results, trajs, args):
    from ..viz import _pyplot

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 7))
    styles = {
        "gt": dict(color="0.3", lw=2.5, alpha=0.6, label="ground truth"),
        "odo": dict(color="#d62728", lw=1, label=(
            f"odometry (ATE {results['odo']['ate_live']:.3f})")),
        "slam_noloop": dict(color="#ff7f0e", lw=1, label=(
            f"SLAM no loops ({results['slam_noloop']['ate_corrected']:.3f})")),
        "slam_pg": dict(color="#1f77b4", lw=1, label=(
            f"+ pose-graph GBA ({results['slam_pg']['ate_corrected']:.3f})")),
        "slam_joint": dict(color="#2ca02c", lw=1.4, label=(
            f"+ joint GBA ({results['slam_joint']['ate_corrected']:.3f})")),
    }
    for k, st in styles.items():
        ax.plot(trajs[k][:, 0], trajs[k][:, 1], **st)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"{args.laps:g} laps, odo noise {tuple(args.noise)}")
    fig.savefig(os.path.join(args.out, "trajectories.png"), dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}/trajectories.png")


def run(args):
    from ..io import SyntheticWorld, ate_se2
    from .run_dataset import have_matplotlib

    cfg = build_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=args.seed)
    gt = lap_sequence(world, args.laps, args.frames_per_lap)
    n = len(gt)
    odo_seeds = args.odo_seeds if args.odo_seeds else [3]

    results = {"config": {
        "laps": args.laps, "frames": n, "noise": list(args.noise),
        "seed": args.seed, "odo_seeds": odo_seeds,
        "joint_iters": cfg.gm_joint_ba_iters,
    }}
    trajs = {"gt": gt[:, :2]}
    per_seed = {}
    for oseed in odo_seeds:
        odo = world.odometry(gt, noise=tuple(args.noise), seed=oseed)
        ate_odo, _ = ate_se2(odo[:, :2], gt[:, :2])
        sres = {"odo": {"ate_live": round(float(ate_odo), 4),
                        "lap_drift": lap_drift(odo, gt, args.frames_per_lap)}}
        if oseed == odo_seeds[0]:
            trajs["odo"] = odo[:, :2]
        print(f"[odo seed {oseed}] odo            ATE {ate_odo:.4f}", flush=True)
        for name, (loops, joint) in zip(ESTIMATORS, ((False, 0), (True, 0),
                                                     (True, cfg.gm_joint_ba_iters))):
            r, corr = run_slam(build_cfg(joint_iters=joint), world, gt, odo, loops,
                               args.frames_per_lap, device=args.device)
            sres[name] = r
            if oseed == odo_seeds[0]:
                trajs[name] = corr[:, :2]
            print(f"[odo seed {oseed}] {name:<14} "
                  f"ATE live {r['ate_live']:.4f} "
                  f"corrected {r['ate_corrected']:.4f} "
                  f"loops {r['n_loops']} kfs {r['n_kfs']} "
                  f"lap drift {r['lap_drift']}", flush=True)
        per_seed[str(oseed)] = sres

    if len(odo_seeds) > 1:
        results["per_seed"] = per_seed
        # seed-wise summary: does SLAM beat raw odometry on every draw?
        for est in ESTIMATORS:
            wins_live = sum(per_seed[s][est]["ate_live"] <= per_seed[s]["odo"]["ate_live"]
                            for s in per_seed)
            wins_corr = sum(per_seed[s][est]["ate_corrected"] <= per_seed[s]["odo"]["ate_live"]
                            for s in per_seed)
            results[f"{est}_beats_odo"] = {"live": f"{wins_live}/{len(per_seed)}",
                                           "corrected": f"{wins_corr}/{len(per_seed)}"}
            print(f"{est}: beats odometry live {wins_live}/{len(per_seed)}"
                  f" corrected {wins_corr}/{len(per_seed)}", flush=True)
    results.update(per_seed[str(odo_seeds[0])])

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    if have_matplotlib():
        _plot(results, trajs, args)
    print(json.dumps(results))
    return results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
