"""Keyframe count and ATE of the synchronous SLAM loop over RANSAC draws,
in the JAX package and (optionally) in the PyTorch port, on the CPU.

Both run ``SlamSystem(cfg, enable_loops=False)`` at the bench
configuration (640x480, 1000 features, 5 levels, default ``Capacity``)
over the first 60 poses of the bench world's 352-pose circle of radius
2.5 m (``SyntheticWorld(n_landmarks=500, seed=0)``), with odometry drawn
at the noise of ``tests/test_system.py`` (0.004, 0.002, 0.002 per step,
seed 1). Only the RANSAC draws change between runs: JAX keys
``PRNGKey(s)``, torch generators seeded ``s``. It prints one JSON line per
draw (keyframe frames, keyframe count, live and re-anchored ATE against
ground truth, each local BA's chi2 ratio) and a summary line; the bounds
``chip_smoke.py`` holds the card's draws to come from it.

Usage: JAX_PLATFORMS=cpu python examples/slam_draws.py [--draws 4] [--port]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES = 60
ODO_NOISE = (0.004, 0.002, 0.002)


def frames(world):
    gt = world.circle_trajectory(352, radius=2.5)[:N_FRAMES]
    odo = world.odometry(gt, noise=ODO_NOISE, seed=1)
    return gt, odo, [world.render(p) for p in gt]


def summarize(slam, gt, seconds):
    from se2lam_tpu_torch.io.trajectory import ate_se2

    est = np.asarray([p for _, p in slam.trajectory])
    cor = slam.corrected_trajectory()[:, 1:3]
    return dict(
        kf_frames=list(slam.kf_frame_ids), n_kf=len(slam.kf_frame_ids),
        ate=ate_se2(est[:, :2], gt[: len(est), :2])[0],
        ate_corrected=ate_se2(cor, gt[: len(cor), :2])[0],
        chi2_ratio_max=max(r["chi2"] / r["chi2_init"] for r in slam.ba_log),
        seconds=seconds,
    )


def jax_draws(n_draws):
    import jax

    from __graft_entry__ import _default_cfg
    from se2lam_tpu.io.synthetic import SyntheticWorld
    from se2lam_tpu.system import SlamSystem

    cfg, _ = _default_cfg()
    gt, odo, imgs = frames(SyntheticWorld(cfg, n_landmarks=500, seed=0))
    out = []
    for s in range(n_draws):
        slam = SlamSystem(cfg, enable_loops=False)
        slam.key = jax.random.PRNGKey(s)
        slam.log_ba = True
        t0 = time.perf_counter()
        for img, o in zip(imgs, odo):
            slam.process(img, o)
        out.append(dict(draw=s, **summarize(slam, gt, time.perf_counter() - t0)))
    return out


def port_draws(n_draws):
    import torch

    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld
    from se2lam_tpu_torch.system import SlamSystem

    torch.set_num_threads(4)
    cfg, _ = default_cfg()
    gt, odo, imgs = frames(SyntheticWorld(cfg, n_landmarks=500, seed=0))
    out = []
    for s in range(n_draws):
        slam = SlamSystem(cfg, enable_loops=False, device="cpu",
                          generator=torch.Generator().manual_seed(s))
        slam.log_ba = True
        t0 = time.perf_counter()
        for img, o in zip(imgs, odo):
            slam.process(img, o)
        out.append(dict(draw=s, **summarize(slam, gt, time.perf_counter() - t0)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--port", action="store_true", help="also run the PyTorch port")
    args = ap.parse_args()
    runs = {"jax": jax_draws}
    if args.port:
        runs["torch"] = port_draws
    summary = {}
    for name, fn in runs.items():
        res = fn(args.draws)
        for r in res:
            print(name, json.dumps(r), flush=True)
        summary[name] = dict(
            n_kf=sorted(r["n_kf"] for r in res),
            ate_min=min(r["ate"] for r in res), ate_max=max(r["ate"] for r in res),
            ate_corrected_max=max(r["ate_corrected"] for r in res),
            chi2_ratio_max=max(r["chi2_ratio_max"] for r in res),
        )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
