"""Render a synthetic rover sequence to disk in the DatasetRoom format
(test/test_vn.cpp:33-55): BMP frames, odo_raw.txt, CamConfig.yml and
Settings.yml, plus gt.txt so ``run_dataset`` can report ATE from disk.

Usage:
    python -m se2lam_tpu_torch.drivers.make_dataset --out /tmp/room --frames 150
    python -m se2lam_tpu_torch.drivers.run_dataset /tmp/room/DatasetRoom --out ./slam_out

``main(argv)`` returns the dataset root. It needs no card.
"""
from __future__ import annotations

import argparse

import numpy as np

from .run_dataset import synthetic_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="./room_dataset")
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--laps", type=float, default=1.2,
                    help="fraction of the circle to drive (>1 revisits)")
    ap.add_argument("--noise", type=float, nargs=3, default=(0.003, 0.002, 0.001),
                    metavar=("X", "Y", "TH"))
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    from ..io import SyntheticWorld, write_dataset_room

    cfg = synthetic_cfg()
    world = SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=args.seed)
    lap = world.circle_trajectory(int(args.frames / args.laps))
    reps = int(np.ceil(args.laps)) + 1
    gt = np.concatenate([lap] * reps)[: args.frames]
    odo = world.odometry(gt, noise=tuple(args.noise), seed=args.seed + 1)
    frames = (world.render(gt[i]) for i in range(args.frames))
    root = write_dataset_room(args.out, frames, odo, cfg, gt=gt)
    print(f"wrote {args.frames} frames to {root}")
    print(f"configs: {args.out}/CamConfig.yml, {args.out}/Settings.yml")
    return root


if __name__ == "__main__":
    main()
