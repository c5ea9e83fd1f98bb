"""The drift study's ``slam_joint`` through both packages on the CPU, the
port on the JAX package's random draws.

The scene is ``examples/study_drift.py``'s: 320x240, 256 features, 2
levels, 128 keyframe and 8192 point slots, odometry noise (0.012, 0.006,
0.006) with draw ``--draw`` (3), here over ``--laps`` laps (1: 90 frames).
The JAX ``SlamSystem`` runs first with its ``PRNGKey(--key)`` for tracking
(``PRNGKey(42 + --key)`` for the loop closer); its per-frame RANSAC draws
and its loop stages' keys are captured (``tests/jax_draws.py``) and passed
to the port's ``study_drift.run_slam`` on the CPU. Printed per package:
keyframes, closures, renewal GBAs, live and corrected SE(2)-aligned ATE,
lap drift and seconds; then the differences. The ATE is compared aligned,
not pose by pose: f32 sums run in another order in the two packages, and
local BA moves keyframes by that much (``ROADMAP.md`` §3).

``--only-jax`` runs the JAX package alone: its spread over RANSAC keys
(``--key``) and over odometry perturbed by ``--perturb`` (eps times a
seeded normal draw, m and rad a frame). ``--scene noise`` runs the noise
study's cell instead (``examples/study_noise.py``: 900 landmarks in a 12 m
room, the 1.0x scale, the estimator at the 0.001 defaults; 2 laps by
default there).

Usage: JAX_PLATFORMS=cpu python examples/torch_long_parity.py [--laps 1]
       [--draw 3] [--key 0] [--perturb 0] [--scene drift|noise] [--only-jax]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

NOISE = (0.012, 0.006, 0.006)


def summary(slam, gt, fpl, seconds):
    from se2lam_tpu_torch.drivers.study_drift import lap_drift
    from se2lam_tpu_torch.io.trajectory import ate_se2

    live = np.asarray([p for _, p in slam.trajectory])
    corr = np.asarray(slam.corrected_trajectory())[:, 1:]
    lc = slam._loop_closer
    return dict(n_kfs=int(slam.n_keyframes()), kf_frames=list(slam.kf_frame_ids),
                n_loops=int(lc.n_loops_closed), n_renewal_gbas=int(lc.n_renewal_gbas),
                ate_live=float(ate_se2(live[:, :2], gt[: len(live), :2])[0]),
                ate_corrected=float(ate_se2(corr[:, :2], gt[: len(corr), :2])[0]),
                lap_drift=lap_drift(corr, gt, fpl), seconds=seconds)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=float, default=1.0)
    ap.add_argument("--frames-per-lap", type=int, default=90)
    ap.add_argument("--draw", type=int, default=3, help="the odometry noise draw")
    ap.add_argument("--key", type=int, default=0, help="the JAX system's RANSAC key")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="add eps * N(0, 1) (seed 123) to the odometry")
    ap.add_argument("--scene", choices=["drift", "noise"], default="drift")
    ap.add_argument("--only-jax", action="store_true")
    args = ap.parse_args()
    if args.key and not args.only_jax:
        ap.error("the captured draws are those of PRNGKey(0): --key needs --only-jax")

    import jax
    import torch

    import study_drift as jax_study
    from jax_draws import jax_stage_keys, run_jax_slam, stage_gumbel
    from se2lam_tpu.system import SlamSystem as JaxSlam
    from se2lam_tpu_torch.convert import config_from_fields
    from se2lam_tpu_torch.drivers import study_drift
    from se2lam_tpu_torch.io import SyntheticWorld

    torch.set_num_threads(4)
    if args.scene == "drift":
        jcfg = jax_study.build_cfg(joint_iters=5)
        world = SyntheticWorld(study_drift.build_cfg(), n_landmarks=600, room=10.0, seed=4)
    else:
        jcfg = jax_study.build_cfg(odo_noise=(0.001, 0.001, 0.001))
        world = SyntheticWorld(study_drift.build_cfg(), n_landmarks=900, room=12.0, seed=4)
    gt = study_drift.lap_sequence(world, args.laps, args.frames_per_lap)
    odo = world.odometry(gt, noise=NOISE, seed=args.draw)
    odo = odo + args.perturb * np.random.default_rng(123).normal(size=odo.shape)
    frames = [(world.render(p), o) for p, o in zip(gt, odo)]

    js = JaxSlam(jcfg, enable_loops=True, detect_loops=True)
    js.key = jax.random.PRNGKey(args.key)
    js._loop_closer.key = jax.random.PRNGKey(42 + args.key)
    t0 = time.perf_counter()
    with jax_stage_keys() as keys:
        noise = run_jax_slam(js, frames)
    out = {"jax": summary(js, gt, args.frames_per_lap, time.perf_counter() - t0)}
    print("jax: " + json.dumps(out["jax"]), flush=True)
    if not args.only_jax:
        tcfg = config_from_fields(dataclasses.asdict(jcfg))
        T, N = tcfg.cap.ransac_trials, tcfg.cap.n_features
        stages = iter(keys)
        t0 = time.perf_counter()
        r, _ = study_drift.run_slam(tcfg, world, gt, odo, True, args.frames_per_lap,
                                    device="cpu", gumbels=noise,
                                    stage_gumbel=lambda: stage_gumbel(next(stages), T, N))
        seconds = time.perf_counter() - t0
        port = dict(r, seconds=seconds, stages_left=sum(1 for _ in stages))
        out["port"] = port
        print("port: " + json.dumps(port), flush=True)
        out["diff"] = dict(
            same_kfs=port["n_kfs"] == out["jax"]["n_kfs"],
            same_loops=port["n_loops"] == out["jax"]["n_loops"],
            same_renewal_gbas=port["n_renewal_gbas"] == out["jax"]["n_renewal_gbas"],
            ate_live=port["ate_live"] - out["jax"]["ate_live"],
            ate_corrected=port["ate_corrected"] - out["jax"]["ate_corrected"])
        print("diff: " + json.dumps(out["diff"]), flush=True)
    print(json.dumps(dict(scene=args.scene, laps=args.laps, draw=args.draw, key=args.key,
                          perturb=args.perturb, **out)))


if __name__ == "__main__":
    main()
