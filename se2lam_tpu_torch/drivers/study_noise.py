"""Odometry-noise robustness sweep (the port of the JAX package's
``examples/study_noise.py``): how accuracy degrades as the wheel odometry
degrades, and what vision and loop closing buy back.

Runs a multi-lap circuit at each odometry-noise scale and, per odometry
draw, the full SLAM (loops and joint GBA) under four estimator noise
models: "default_0.001" (the configuration left at the 0.001 defaults
while the simulation draws base*scale), "half", "matched" (the truth) and
"double". Reports raw odometry's ATE, SLAM's live and corrected ATE,
closures and keyframes per run, and with several draws each cell's mean
and spread. Reuses the drift study's configuration and runner.

Usage:
    python -m se2lam_tpu_torch.drivers.study_noise [--scales 1.0]
        [--odo-seeds 3 5 7 11] [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the results dict they write.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .study_drift import build_cfg, lap_sequence, run_slam

BASE_NOISE = (0.012, 0.006, 0.006)
MODES = ("default_0.001", "half", "matched", "double")


def mode_noise(mode, scale):
    """The estimator's odometry noise model of ``mode`` at ``scale``."""
    base = np.asarray(BASE_NOISE)
    return {"default_0.001": (0.001, 0.001, 0.001),
            "half": tuple(0.5 * base * scale),
            "matched": tuple(base * scale),
            "double": tuple(2.0 * base * scale)}[mode]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", type=float, default=2.0)
    ap.add_argument("--frames-per-lap", type=int, default=90)
    ap.add_argument("--scales", type=float, nargs="+",
                    default=[0.5, 1.0, 2.0, 4.0],
                    help="multipliers on the base noise "
                         "(0.012, 0.006, 0.006)")
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--odo-seeds", type=int, nargs="*", default=None,
                    help="odometry draws per cell (default: the single "
                         "draw seed + 100 * scale); with several, the "
                         "summary reports each cell's mean and std")
    ap.add_argument("--out", default="artifacts/torch_noise_study")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args):
    from ..io import SyntheticWorld, ate_se2

    os.makedirs(args.out, exist_ok=True)
    base = np.asarray(BASE_NOISE)
    rows = []
    for scale in args.scales:
        sim_noise = tuple(base * scale)
        world = SyntheticWorld(build_cfg(), n_landmarks=900, room=12.0, seed=args.seed)
        gt = lap_sequence(world, args.laps, args.frames_per_lap)
        odo_seeds = args.odo_seeds if args.odo_seeds else [args.seed + int(scale * 100)]
        for oseed in odo_seeds:
            odo = world.odometry(gt, noise=sim_noise, seed=oseed)
            ate_odo, _ = ate_se2(odo[:, :2], gt[:, :2])
            for mode in MODES:
                res, _ = run_slam(build_cfg(odo_noise=mode_noise(mode, scale)), world, gt, odo,
                                  True, args.frames_per_lap, device=args.device)
                row = {
                    "noise_scale": scale,
                    "odo_cfg": mode,
                    "odo_seed": oseed,
                    "ate_odo": round(float(ate_odo), 4),
                    "ate_slam_live": res["ate_live"],
                    "ate_slam_corrected": res["ate_corrected"],
                    "n_loops": res["n_loops"],
                    "n_kfs": res["n_kfs"],
                }
                rows.append(row)
                print(json.dumps(row), flush=True)

    summary = {}
    if args.odo_seeds and len(args.odo_seeds) > 1:
        for scale in args.scales:
            for mode in MODES:
                cell = [r for r in rows if r["noise_scale"] == scale and r["odo_cfg"] == mode]
                if not cell:
                    continue
                corr = np.asarray([r["ate_slam_corrected"] for r in cell])
                odo_a = np.asarray([r["ate_odo"] for r in cell])
                summary[f"{scale}x/{mode}"] = {
                    "corrected_mean": round(float(corr.mean()), 4),
                    "corrected_std": round(float(corr.std()), 4),
                    "odo_mean": round(float(odo_a.mean()), 4),
                    "beats_odo": f"{int((corr <= odo_a).sum())}/{len(cell)}",
                }
                print(f"{scale}x/{mode}: corrected "
                      f"{corr.mean():.4f}±{corr.std():.4f} "
                      f"(odo {odo_a.mean():.4f}, beats "
                      f"{int((corr <= odo_a).sum())}/{len(cell)})", flush=True)
    results = {"laps": args.laps, "base_noise": base.tolist(), "rows": rows, "summary": summary}
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", os.path.join(args.out, "results.json"))
    return results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
