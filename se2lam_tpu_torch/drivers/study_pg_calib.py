"""Calibration of the pose-graph-only loop-closure regime (the port of the
JAX package's ``examples/study_pg_calib.py``).

The two free parameters of a pose-graph-only closure (``slam_pg``: the
GlobalBA and the rigid map-point re-anchor, no joint BA) are the Huber
kink of the pose-graph edges and the eigenvalue ceiling of the sparsified
loop-edge information (the Sparsifier's clamp, src/sparsifier.cpp:239-263).
This sweep runs the drift study's sequence through ``slam_pg`` for a
(huber, ceiling) grid and reports per-lap drift and corrected ATE against
the odometry floor.

Usage:
    python -m se2lam_tpu_torch.drivers.study_pg_calib [--hubers 3.0]
        [--ceils 1e4 1e2] [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the results dict they write.
"""
from __future__ import annotations

import argparse
import json
import os

from .study_drift import build_cfg, lap_drift, lap_sequence, run_slam


def grid_cfg(huber, ceil):
    """``slam_pg``'s configuration at one grid cell."""
    return build_cfg(joint_iters=0).replace(gm_pg_huber=float(huber),
                                            gm_loop_info_ceil=float(ceil))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", type=float, default=3.0)
    ap.add_argument("--frames-per-lap", type=int, default=90)
    ap.add_argument("--noise", type=float, nargs=3,
                    default=(0.012, 0.006, 0.006))
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--odo-seed", type=int, default=3,
                    help="odometry noise realization (the world seed "
                         "only varies the landmarks/descriptors)")
    ap.add_argument("--hubers", type=float, nargs="*",
                    default=[1e9, 3.0, 1.0])
    ap.add_argument("--ceils", type=float, nargs="*",
                    default=[1e4, 1e3, 3e2, 1e2])
    ap.add_argument("--out", default="artifacts/torch_pg_calib")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args):
    from ..io import SyntheticWorld, ate_se2

    world = SyntheticWorld(build_cfg(), n_landmarks=600, room=10.0, seed=args.seed)
    gt = lap_sequence(world, args.laps, args.frames_per_lap)
    odo = world.odometry(gt, noise=tuple(args.noise), seed=args.odo_seed)
    ate_odo, _ = ate_se2(odo[:, :2], gt[:, :2])
    results = {
        "config": {"laps": args.laps, "frames": len(gt),
                   "noise": list(args.noise), "seed": args.seed},
        "odo": {"ate": round(float(ate_odo), 4),
                "lap_drift": lap_drift(odo, gt, args.frames_per_lap)},
        "grid": [],
    }
    print(f"odo  ATE {ate_odo:.4f} lap drift {results['odo']['lap_drift']}")
    for huber in args.hubers:
        for ceil in args.ceils:
            r, _ = run_slam(grid_cfg(huber, ceil), world, gt, odo, True, args.frames_per_lap,
                            device=args.device)
            results["grid"].append({"huber": huber, "ceil": ceil, **r})
            print(f"huber {huber:>6g} ceil {ceil:>6g}: "
                  f"ATE corr {r['ate_corrected']:.4f} "
                  f"loops {r['n_loops']} lap drift {r['lap_drift']}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results["odo"]))
    return results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
