"""Fleet rendezvous demo: robots map different parts of one environment
independently, the maps merge, and a fleet localizes against the union
(the reference is single-session and single-map):

1. mapping per robot (``SlamSystem``, each in its own gauge);
2. ``mapmerge.merge_maps`` aligns and fuses the maps (BoW place
   recognition across maps, SE(2) alignment, duplicate-landmark fusion,
   global BA);
3. ``parallel.make_fleet_localizer`` serves B robots x k frames a step on
   the one merged map.

Usage: python -m se2lam_tpu_torch.drivers.fleet_demo [--frames 80]
           [--out ./fleet_out] [--device cpu]
Prints a JSON summary line; ``main(argv)`` returns it as a dict.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .run_dataset import synthetic_cfg


def _minus(p, ref):
    """``se2.minus(p, ref)``'s position on the host: p in ref's frame."""
    d = np.asarray(p[:2], np.float64) - ref[:2]
    c, s = np.cos(ref[2]), np.sin(ref[2])
    return np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                       np.arctan2(np.sin(p[2] - ref[2]), np.cos(p[2] - ref[2]))], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=80, help="circuit length in frames")
    ap.add_argument("--out", default="./fleet_out")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..io import SyntheticWorld, save_map
    from ..mapmerge import merge_maps
    from ..parallel import make_fleet_localizer
    from ..system import SlamSystem

    dev = resolve_device(args.device)
    cfg = synthetic_cfg()
    world = SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=1)
    n = args.frames
    gt = np.asarray(world.circle_trajectory(n))

    # 1. two robots map overlapping halves, each in its own gauge. B starts
    # well before the overlap so its landmarks have matured (parallax,
    # observations) when it crosses A's part: young border keyframes carry
    # few map points and fail the seam's verification gates
    halves = [list(range(0, int(n * 0.6))), list(range(int(n * 0.3), n))]
    maps = []
    for r, frames in enumerate(halves):
        slam = SlamSystem(cfg, enable_loops=False, device=dev)
        for i in frames:
            slam.process(world.render(gt[i]), np.asarray(gt[i], np.float32))
        print(f"robot {r}: mapped {len(frames)} frames -> {slam.n_keyframes()} KFs",
              flush=True)
        maps.append(slam.ms)

    # 2. the rendezvous: B merges into A's frame
    merged, info = merge_maps(maps[0], maps[1], cfg, device=dev)
    print(f"merged at pair {info['pair']}, {info['mps_fused']} duplicate landmarks fused, "
          f"seam inliers {info['seam_edge_inliers']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    save_map(os.path.join(args.out, "merged_map"), merged, info["vocab"])

    # 3. a fleet of B robots localizes on the union
    B, k = 2, 8
    extract_l, step_l = make_fleet_localizer(cfg, merged, device=dev)
    anchor = gt[halves[0][0]]                         # A's gauge
    starts = [int(n * 0.15), int(n * 0.8)]            # one robot a half
    imgs, odos, seeds, last = [], [], [], []
    for b in range(B):
        idx = [(starts[b] + i) % n for i in range(k + 1)]
        imgs.append(np.stack([world.render(gt[j]) for j in idx[1:]]))
        odos.append(np.stack([gt[j] for j in idx[1:]]))
        seeds.append(_minus(gt[idx[0]], anchor))
        last.append(gt[idx[0]])
    poses, tracked = step_l(np.stack(seeds), np.stack(last),
                            extract_l(np.stack(imgs)), np.stack(odos))
    poses, tracked = poses.cpu().numpy(), tracked.cpu().numpy()
    # the served poses against ground truth in A's gauge
    errs = [np.linalg.norm(poses[b, i, :2] - _minus(gt[(starts[b] + 1 + i) % n], anchor)[:2])
            for b in range(B) for i in range(k) if tracked[b, i]]
    out = {
        "metric": "fleet_rendezvous", "robots_mapping": len(halves),
        "merged_kfs": int(merged.n_kf), "mps_fused": info["mps_fused"],
        "fleet_B": B, "chunk_k": k, "tracked": int(tracked.sum()), "total": B * k,
        "max_pose_err_m": round(float(np.max(errs)), 4) if errs else None,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
