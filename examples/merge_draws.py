"""Map merging over RANSAC draws, in the JAX package and (optionally) in
the PyTorch port, on the CPU.

Scene (``examples/fleet_demo.py``'s): ``SyntheticWorld(n_landmarks=800,
room=12.0, seed=1)``, an 80-frame circle; robot A maps frames 0-47 and
robot B frames 24-79, each with ``SlamSystem(cfg, enable_loops=False)``
at the bench configuration (640x480, 1000 features, 5 levels, default
``Capacity``) and odometry noise (0.004, 0.002, 0.002) per step, seed 0,
integrated over its own segment. Each map is in its robot's gauge.

Draws: the maps are built with tracking draws ``m`` (JAX ``PRNGKey(m)``,
torch generator seeded ``m``) for ``--maps`` values of ``m`` from
``--first-map``; each pair of maps is
merged with merge draws ``42 + d`` for ``d < --draws`` (JAX
``merge_maps(key=PRNGKey(42 + d))``, the port's
``merge_maps(generator=torch.Generator().manual_seed(42 + d))``).

Per merge it prints one JSON line: the chosen pair as slots and as the
frames of those keyframes, the BoW score, alignment inliers, seam
verification counts, fused map points, the merged keyframe count, and
the largest distance of B's keyframes, in A's gauge, from ground truth;
then a summary line per package. The bounds ``chip_smoke.py`` holds the
card's merges to come from it.

Usage: JAX_PLATFORMS=cpu python examples/merge_draws.py [--maps 3]
       [--first-map 0] [--draws 3] [--port | --only-port]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_CIRCLE = 80
A_FRAMES = range(0, 48)
B_FRAMES = range(24, 80)
ODO_NOISE = (0.004, 0.002, 0.002)
# the loop phase's keyframe cadence (tests/test_loop_reference_gates.py)
CADENCE = dict(min_frames_between_kf=2, max_frames_between_kf=8)


def scene(world):
    gt = np.asarray(world.circle_trajectory(N_CIRCLE))
    segs = []
    for frames in (A_FRAMES, B_FRAMES):
        g = gt[list(frames)]
        segs.append((list(frames), world.odometry(g, noise=ODO_NOISE, seed=0),
                     [world.render(p) for p in g]))
    return gt, segs


def gauge(p, ref):
    """``p`` expressed in ``ref``'s frame (se2.minus), on the host."""
    d = p[:2] - ref[:2]
    c, s = np.cos(ref[2]), np.sin(ref[2])
    return np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1]])


def live_frames(slam):
    """Frame ids of the live keyframes in slot order: the order in which
    ``merge_maps``' compaction lays them out."""
    valid = np.asarray(slam.ms.kf_valid)[: len(slam.kf_frame_ids)]
    return [f for f, v in zip(slam.kf_frame_ids, valid) if v]


def b_error(kf_pose, na, b_frames, gt):
    """Largest distance of B's keyframes (merged slots na...) from ground
    truth in A's gauge."""
    a0 = gt[A_FRAMES[0]]
    errs = [np.linalg.norm(kf_pose[na + i, :2] - gauge(gt[B_FRAMES[f]], a0))
            for i, f in enumerate(b_frames)]
    return float(max(errs))


def summarize(info, merged_n_kf, kf_pose, fa, fb, gt, seconds):
    ka, kb = info["pair"]
    return dict(
        pair=[int(ka), int(kb)], pair_frames=[A_FRAMES[fa[ka]], B_FRAMES[fb[kb]]],
        bow_score=float(info["bow_score"]), align_inliers=int(info["align_inliers"]),
        n_kp=int(info["n_kp"]), n_mp_pairs=int(info["n_mp_pairs"]),
        mps_fused=int(info["mps_fused"]), seam_edge_inliers=int(info["seam_edge_inliers"]),
        n_kf=int(merged_n_kf), n_kf_a=len(fa), n_kf_b=len(fb),
        b_kf_err_max=b_error(kf_pose, len(fa), fb, gt), seconds=seconds,
    )


def jax_draws(maps, n_draws):
    import jax

    from __graft_entry__ import _default_cfg
    from se2lam_tpu.io.synthetic import SyntheticWorld
    from se2lam_tpu.mapmerge import merge_maps
    from se2lam_tpu.system import SlamSystem

    cfg = _default_cfg()[0].replace(**CADENCE)
    gt, segs = scene(SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=1))
    out = []
    for m in maps:
        slams = []
        for _, odo, imgs in segs:
            slam = SlamSystem(cfg, enable_loops=False)
            slam.key = jax.random.PRNGKey(m)
            for img, o in zip(imgs, odo):
                slam.process(img, o)
            slams.append(slam)
        fa, fb = (live_frames(s) for s in slams)
        for d in range(n_draws):
            t0 = time.perf_counter()
            merged, info = merge_maps(slams[0].ms, slams[1].ms, cfg,
                                      key=jax.random.PRNGKey(42 + d))
            jax.block_until_ready(merged.kf_pose)
            out.append(dict(maps=m, draw=42 + d, **summarize(
                info, merged.n_kf, np.asarray(merged.kf_pose), fa, fb, gt,
                time.perf_counter() - t0)))
            print("jax", json.dumps(out[-1]), flush=True)
    return out


def port_draws(maps, n_draws):
    import torch

    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld
    from se2lam_tpu_torch.mapmerge import merge_maps
    from se2lam_tpu_torch.system import SlamSystem

    torch.set_num_threads(4)
    cfg = default_cfg()[0].replace(**CADENCE)
    gt, segs = scene(SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=1))
    out = []
    for m in maps:
        slams = []
        for _, odo, imgs in segs:
            slam = SlamSystem(cfg, enable_loops=False, device="cpu",
                              generator=torch.Generator().manual_seed(m))
            for img, o in zip(imgs, odo):
                slam.process(img, o)
            slams.append(slam)
        fa, fb = (live_frames(s) for s in slams)
        for d in range(n_draws):
            t0 = time.perf_counter()
            merged, info = merge_maps(slams[0].ms, slams[1].ms, cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(42 + d))
            out.append(dict(maps=m, draw=42 + d, **summarize(
                info, merged.n_kf, merged.kf_pose.numpy(), fa, fb, gt,
                time.perf_counter() - t0)))
            print("torch", json.dumps(out[-1]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", type=int, default=3, help="mapping draws")
    ap.add_argument("--first-map", type=int, default=0, help="the first mapping draw")
    ap.add_argument("--draws", type=int, default=3, help="merge draws per pair of maps")
    ap.add_argument("--port", action="store_true", help="also run the PyTorch port")
    ap.add_argument("--only-port", action="store_true", help="run the PyTorch port alone")
    args = ap.parse_args()
    runs = {} if args.only_port else {"jax": jax_draws}
    if args.port or args.only_port:
        runs["torch"] = port_draws
    for name, fn in runs.items():
        res = fn(range(args.first_map, args.first_map + args.maps), args.draws)
        print(name, "summary", json.dumps(dict(
            pair_frames=sorted({tuple(r["pair_frames"]) for r in res}),
            align_inliers=[min(r["align_inliers"] for r in res),
                           max(r["align_inliers"] for r in res)],
            mps_fused=[min(r["mps_fused"] for r in res), max(r["mps_fused"] for r in res)],
            b_kf_err_max=max(r["b_kf_err_max"] for r in res),
            n_kf_a=sorted({r["n_kf_a"] for r in res}), n_kf_b=sorted({r["n_kf_b"] for r in res}),
        )), flush=True)


if __name__ == "__main__":
    main()
