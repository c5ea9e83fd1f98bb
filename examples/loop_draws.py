"""Loop closing and capacity relief over RANSAC draws, in the JAX package
and (optionally) in the PyTorch port, on the CPU.

Loop phase: ``SlamSystem(cfg)`` with its defaults (loops on) at the bench
configuration (640x480, 1000 features, 5 levels, default ``Capacity``:
256 keyframes, 8192 points) with the keyframe cadence of
``tests/test_loop_reference_gates.py`` (2-8 frames) and the reference's
untouched loop gates, on that test's scene: ``SyntheticWorld(n_landmarks=
1200, room=10.0, seed=4)``, a 72-frame lap plus 24 revisit frames,
odometry noise (0.004, 0.002, 0.002) per step, seed 3.

Relief phase: the same world and configuration, loops on, with the banks
cut to ``RELIEF_KFS`` keyframes and ``RELIEF_MPS`` points so that both the
keyframe-side and the point-side relief run.

Only the RANSAC draws change between runs: JAX keys ``PRNGKey(s)`` for
tracking and ``PRNGKey(42 + s)`` for the loop closer; torch generators
seeded ``s`` and ``42 + s``. It prints one JSON line per draw and a
summary line per package and phase; the bounds ``chip_smoke.py`` holds
the card's draws to come from it.

Usage: JAX_PLATFORMS=cpu python examples/loop_draws.py [--draws 4] [--port]
       [--phase loop|relief|both]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ODO_NOISE = (0.004, 0.002, 0.002)
CADENCE = dict(min_frames_between_kf=2, max_frames_between_kf=8)
RELIEF_KFS, RELIEF_MPS, RELIEF_FRAMES = 16, 2048, 72


def frames(world):
    lap = world.circle_trajectory(72)
    gt = np.concatenate([lap, lap[:24]])
    odo = world.odometry(gt, noise=ODO_NOISE, seed=3)
    return gt, odo, [world.render(p) for p in gt]


def phase_cfg(base, phase):
    import dataclasses

    cfg = base.replace(**CADENCE)
    if phase == "relief":
        cfg = cfg.replace(cap=dataclasses.replace(cfg.cap, max_kfs=RELIEF_KFS,
                                                  max_mps=RELIEF_MPS))
    return cfg


def summarize(slam, gt, odo, seconds):
    from se2lam_tpu_torch.io.trajectory import ate_se2

    lc = slam._loop_closer
    est = np.asarray([p for _, p in slam.trajectory])
    cor = slam.corrected_trajectory()[:, 1:3]
    return dict(
        kf_frames=list(slam.kf_frame_ids), n_kf=len(slam.kf_frame_ids),
        n_loops=lc.n_loops_closed, last_loop=lc.last_loop,
        renewal_gbas=lc.n_renewal_gbas, vocab_trainings=lc.n_vocab_trainings,
        ate=ate_se2(est[:, :2], gt[: len(est), :2])[0],
        ate_corrected=ate_se2(cor, gt[: len(cor), :2])[0],
        ate_odometry=ate_se2(odo[:, :2], gt[:, :2])[0],
        capacity_compactions=slam.capacity_compactions, mp_compactions=slam.mp_compactions,
        mp_culled_weak=slam.mp_culled_weak, max_n_kf=int(slam.ms.n_kf),
        n_mp=int(slam.ms.n_mp), seconds=seconds,
    )


def jax_draws(phase, n_draws):
    import jax

    from __graft_entry__ import _default_cfg
    from se2lam_tpu.io.synthetic import SyntheticWorld
    from se2lam_tpu.system import SlamSystem

    base, _ = _default_cfg()
    cfg = phase_cfg(base, phase)
    gt, odo, imgs = frames(SyntheticWorld(cfg, n_landmarks=1200, room=10.0, seed=4))
    if phase == "relief":
        gt, odo, imgs = gt[:RELIEF_FRAMES], odo[:RELIEF_FRAMES], imgs[:RELIEF_FRAMES]
    out = []
    for s in range(n_draws):
        slam = SlamSystem(cfg)
        slam.key = jax.random.PRNGKey(s)
        slam._loop_closer.key = jax.random.PRNGKey(42 + s)
        t0 = time.perf_counter()
        for img, o in zip(imgs, odo):
            slam.process(img, o)
        out.append(dict(draw=s, **summarize(slam, gt, odo, time.perf_counter() - t0)))
    return out


def port_draws(phase, n_draws):
    import torch

    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld
    from se2lam_tpu_torch.system import SlamSystem

    torch.set_num_threads(4)
    base, _ = default_cfg()
    cfg = phase_cfg(base, phase)
    gt, odo, imgs = frames(SyntheticWorld(cfg, n_landmarks=1200, room=10.0, seed=4))
    if phase == "relief":
        gt, odo, imgs = gt[:RELIEF_FRAMES], odo[:RELIEF_FRAMES], imgs[:RELIEF_FRAMES]
    out = []
    for s in range(n_draws):
        slam = SlamSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(s))
        slam._loop_closer.generator = torch.Generator().manual_seed(42 + s)
        t0 = time.perf_counter()
        for img, o in zip(imgs, odo):
            slam.process(img, o)
        out.append(dict(draw=s, **summarize(slam, gt, odo, time.perf_counter() - t0)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--port", action="store_true", help="also run the PyTorch port")
    ap.add_argument("--phase", choices=["loop", "relief", "both"], default="both")
    ap.add_argument("--only-port", action="store_true", help="run the PyTorch port alone")
    args = ap.parse_args()
    runs = {} if args.only_port else {"jax": jax_draws}
    if args.port or args.only_port:
        runs["torch"] = port_draws
    phases = ["loop", "relief"] if args.phase == "both" else [args.phase]
    for phase in phases:
        for name, fn in runs.items():
            res = fn(phase, args.draws)
            for r in res:
                print(phase, name, json.dumps(r), flush=True)
            print(phase, name, "summary", json.dumps(dict(
                n_kf=sorted(r["n_kf"] for r in res),
                n_loops=sorted(r["n_loops"] for r in res),
                ate_max=max(r["ate"] for r in res),
                ate_corrected_max=max(r["ate_corrected"] for r in res),
                ate_odometry=res[0]["ate_odometry"],
                capacity_compactions=sorted(r["capacity_compactions"] for r in res),
                mp_compactions=sorted(r["mp_compactions"] for r in res),
            )), flush=True)


if __name__ == "__main__":
    main()
