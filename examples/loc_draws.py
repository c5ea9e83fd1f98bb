"""Localization and resume over RANSAC draws, in the JAX package and
(optionally) in the PyTorch port, on the CPU.

The map: ``SlamSystem(cfg, enable_loops=False)`` at the bench
configuration (640x480, 1000 features, 5 levels, default ``Capacity``)
over the first 60 poses of the bench world's 352-pose circle of radius
2.5 m (``SyntheticWorld(n_landmarks=500, seed=0)``, odometry noise
(0.004, 0.002, 0.002) per step, seed 1), saved with ``save_map`` (its
512-word vocabulary included). Then, per draw:

- localization: a ``Localizer`` on that map, cold (kidnapped), over
  frames 10-49 with fresh odometry noise (0.002, 0.001, 0.001), seed 9;
- resume: ``SlamSystem.resume`` on the map over frames 30-59 with the
  same odometry.

Only the RANSAC draws change between draws: JAX keys ``PRNGKey(s)``
(the Localizer's and ``SlamSystem``'s), torch generators seeded ``s``.
Per draw it prints the first localized frame, the localized count and the
median position error against ground truth in the map's gauge
(``se2.minus(gt[i], gt[0])``), and for resume the relocalized frame, the
keyframes inserted, the median error and the largest local-BA chi2
ratio; then a summary line. ``chip_smoke.py``'s bounds come from it.

Usage: JAX_PLATFORMS=cpu python examples/loc_draws.py [--draws 6] [--port]
       [--min-inliers 45]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from se2lam_tpu_torch.io.synthetic import map_gauge  # noqa: E402

MAP_FRAMES = 60
MAP_NOISE = (0.004, 0.002, 0.002)
LOC_FRAMES = range(10, 50)
RESUME_FRAMES = range(30, 60)
LOC_NOISE = (0.002, 0.001, 0.001)


def summarize_loc(poses, frames, gt_map):
    hit = [(i, p) for i, p in zip(frames, poses) if p is not None]
    errs = [float(np.linalg.norm(np.asarray(p)[:2] - gt_map[i])) for i, p in hit]
    return dict(first=hit[0][0] if hit else None, n_localized=len(hit),
                median_err=float(np.median(errs)) if errs else None)


def summarize_resume(poses, frames, gt_map, n_kf_before, n_kf, ba_log):
    hit = [(i, p) for i, p in zip(frames, poses) if np.linalg.norm(p) > 1e-6]
    errs = [float(np.linalg.norm(np.asarray(p)[:2] - gt_map[i])) for i, p in hit]
    return dict(reloc_frame=hit[0][0] if hit else None, kf_inserted=n_kf - n_kf_before,
                median_err=float(np.median(errs)) if errs else None,
                chi2_ratio_max=max((r["chi2"] / r["chi2_init"] for r in ba_log), default=None))


def jax_draws(n_draws, min_inliers, tmp):
    import jax

    from __graft_entry__ import _default_cfg
    from se2lam_tpu.io import load_map
    from se2lam_tpu.io.synthetic import SyntheticWorld
    from se2lam_tpu.localizer import Localizer
    from se2lam_tpu.system import SlamSystem

    cfg, _ = _default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    imgs = [world.render(p) for p in gt]
    slam = SlamSystem(cfg, enable_loops=False)
    for img, o in zip(imgs, world.odometry(gt, noise=MAP_NOISE, seed=1)):
        slam.process(img, o)
    path = os.path.join(tmp, "jax_map")
    slam.save_map(path)
    n_kf = slam.n_keyframes()
    odo = world.odometry(gt, noise=LOC_NOISE, seed=9)
    gt_map = map_gauge(gt)
    out = []
    for s in range(n_draws):
        ms, vocab, _ = load_map(path)
        loc = Localizer(cfg, ms, vocab, reloc_min_inliers=min_inliers)
        loc.key = jax.random.PRNGKey(s)
        t0 = time.perf_counter()
        poses = [loc.process(imgs[i], odo[i]) for i in LOC_FRAMES]
        rec = dict(draw=s, map_kf=n_kf, loc=summarize_loc(poses, LOC_FRAMES, gt_map),
                   loc_s=time.perf_counter() - t0)
        res = SlamSystem.resume(cfg, path, enable_loops=False)
        res.key = jax.random.PRNGKey(s)
        res._reloc_localizer.key = jax.random.PRNGKey(s)
        res.log_ba = True
        poses = [res.process(imgs[i], odo[i]) for i in RESUME_FRAMES]
        rec["resume"] = summarize_resume(poses, RESUME_FRAMES, gt_map, n_kf,
                                         res.n_keyframes(), res.ba_log)
        out.append(rec)
    return out


def port_draws(n_draws, min_inliers, tmp):
    import torch

    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.io import load_map
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld
    from se2lam_tpu_torch.localizer import Localizer
    from se2lam_tpu_torch.system import SlamSystem

    torch.set_num_threads(4)
    cfg, _ = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    imgs = [world.render(p) for p in gt]
    slam = SlamSystem(cfg, enable_loops=False, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    for img, o in zip(imgs, world.odometry(gt, noise=MAP_NOISE, seed=1)):
        slam.process(img, o)
    path = os.path.join(tmp, "port_map")
    slam.save_map(path)
    n_kf = slam.n_keyframes()
    odo = world.odometry(gt, noise=LOC_NOISE, seed=9)
    gt_map = map_gauge(gt)
    out = []
    for s in range(n_draws):
        ms, vocab, _ = load_map(path, device="cpu")
        loc = Localizer(cfg, ms, vocab, reloc_min_inliers=min_inliers, device="cpu",
                        generator=torch.Generator().manual_seed(s))
        t0 = time.perf_counter()
        poses = [loc.process(imgs[i], odo[i]) for i in LOC_FRAMES]
        rec = dict(draw=s, map_kf=n_kf, loc=summarize_loc(poses, LOC_FRAMES, gt_map),
                   loc_s=time.perf_counter() - t0)
        res = SlamSystem.resume(cfg, path, device="cpu",
                                generator=torch.Generator().manual_seed(s))
        res.log_ba = True
        poses = [res.process(imgs[i], odo[i]) for i in RESUME_FRAMES]
        rec["resume"] = summarize_resume(poses, RESUME_FRAMES, gt_map, n_kf,
                                         res.n_keyframes(), res.ba_log)
        out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=6)
    ap.add_argument("--port", action="store_true", help="also run the PyTorch port")
    ap.add_argument("--min-inliers", type=int, default=45,
                    help="the Localizer's reloc_min_inliers")
    args = ap.parse_args()
    runs = {"jax": jax_draws}
    if args.port:
        runs["torch"] = port_draws
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in runs.items():
            res = fn(args.draws, args.min_inliers, tmp)
            for r in res:
                print(name, json.dumps(r), flush=True)
            loc = [r["loc"] for r in res]
            rs = [r["resume"] for r in res]
            summary[name] = dict(
                min_inliers=args.min_inliers,
                loc_first=sorted(str(x["first"]) for x in loc),
                loc_n_localized=[min(x["n_localized"] for x in loc),
                                 max(x["n_localized"] for x in loc)],
                loc_median_err_max=max((x["median_err"] for x in loc if x["median_err"]
                                        is not None), default=None),
                resume_reloc_frame=sorted(str(x["reloc_frame"]) for x in rs),
                resume_kf_inserted=sorted(x["kf_inserted"] for x in rs),
                resume_median_err_max=max((x["median_err"] for x in rs if x["median_err"]
                                           is not None), default=None),
            )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
