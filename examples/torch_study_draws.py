"""The port's spread over its own RANSAC draws on the drift and noise
studies' cells, the counterpart of ``examples/torch_long_parity.py
--only-jax --key k`` for the JAX package.

Each run is one ``study_drift.run_slam`` on the card (or ``--device``)
with the tracking generator seeded ``s`` and the loop closer's ``42 + s``
(the studies' own runs use ``s = 0``):

- ``--scene drift``: ``slam_joint`` of ``examples/study_drift.py`` over
  ``--laps`` laps on odometry draw ``--draw``;
- ``--scene noise``: ``examples/study_noise.py``'s 1.0x cell with the
  estimator at the 0.001 defaults, 2 laps.

Prints one JSON line a seed (live and corrected ATE, closures, keyframes,
lap drift and its least-squares slope a lap, seconds) and the odometry's
ATE.

Usage: python examples/torch_study_draws.py --scene drift --laps 3
       --draw 5 --seeds 1 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=["drift", "noise"], default="drift")
    ap.add_argument("--laps", type=float, default=None,
                    help="default: 3 (drift), 2 (noise)")
    ap.add_argument("--draw", type=int, default=3, help="the odometry noise draw")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    import torch

    from se2lam_tpu_torch.drivers import study_drift
    from se2lam_tpu_torch.io import SyntheticWorld, ate_se2

    if args.scene == "drift":
        cfg = study_drift.build_cfg(joint_iters=5)
        world = SyntheticWorld(study_drift.build_cfg(), n_landmarks=600, room=10.0, seed=4)
        laps = 3.0 if args.laps is None else args.laps
    else:
        cfg = study_drift.build_cfg(odo_noise=(0.001, 0.001, 0.001))
        world = SyntheticWorld(study_drift.build_cfg(), n_landmarks=900, room=12.0, seed=4)
        laps = 2.0 if args.laps is None else args.laps
    gt = study_drift.lap_sequence(world, laps, 90)
    odo = world.odometry(gt, noise=(0.012, 0.006, 0.006), seed=args.draw)
    print(json.dumps(dict(scene=args.scene, laps=laps, draw=args.draw,
                          ate_odo=ate_se2(odo[:, :2], gt[:, :2])[0])), flush=True)
    for s in args.seeds:
        def reseed(i, slam, s=s):
            if i == 0:
                slam.generator.manual_seed(s)
                slam._loop_closer.generator.manual_seed(42 + s)

        t0 = time.perf_counter()
        r, _ = study_drift.run_slam(cfg, world, gt, odo, True, 90, device=args.device,
                                    on_frame=reseed)
        y = np.asarray(r["lap_drift"])
        slope = float(np.polyfit(np.arange(1, len(y) + 1), y, 1)[0]) if len(y) > 1 else None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(json.dumps(dict(seed=s, **r, lap_drift_slope=slope,
                              seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
