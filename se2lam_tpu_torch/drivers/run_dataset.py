"""Offline SLAM driver, the reference's test_vn (test/test_vn.cpp).

Runs SLAM over a DatasetRoom-format directory (``image/<i>.bmp`` +
``odo_raw.txt``) or, with ``--synthetic``, over the synthetic rover world.
Writes the keyframe trajectory in the reference's txt format, the map with
its vocabulary, and, where matplotlib is installed, the trajectory and map
plots.

Usage:
    python -m se2lam_tpu_torch.drivers.run_dataset <dataset_dir>
        [--cam CamConfig.yml] [--settings Settings.yml] [--out outdir]
        [--frames N] [--chunk K] [--resume MAP_DIR] [--no-loops]
        [--viz-every N] [--device cpu]
    python -m se2lam_tpu_torch.drivers.run_dataset --synthetic [--frames N]

``main(argv)`` returns the ``SlamSystem`` it ran.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time

import numpy as np

from ..config import Capacity, SystemConfig
from ..frontend.orb import OrbConfig


def synthetic_cfg(n_features=500, n_levels=3):
    """The synthetic demo configuration: 640x480, 500 features, 3 levels,
    a keyframe every 2-6 frames (the circle turns fast per frame)."""
    Tcb = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], float)
    oc = OrbConfig(height=480, width=640, n_features=n_features, scale_factor=1.2,
                   n_levels=n_levels)
    return SystemConfig(
        width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0,
        Tbc=tuple(np.linalg.inv(Tcb).ravel()), upper_depth=30.0, lower_depth=0.2,
        max_feature_num=n_features, max_level=n_levels,
        min_frames_between_kf=2, max_frames_between_kf=6,
        cap=Capacity(n_features=oc.n_slots),
    )


def dataset_cfg(dataset, cam=None, settings=None):
    """The dataset's CamConfig.yml and Settings.yml (default: beside its
    directory), or the synthetic configuration without them."""
    cam = cam or os.path.join(dataset, "..", "CamConfig.yml")
    st = settings or os.path.join(dataset, "..", "Settings.yml")
    if os.path.exists(cam) and os.path.exists(st):
        return SystemConfig.from_yaml(cam, st)
    print("warning: config YAMLs not found, using defaults")
    return synthetic_cfg()


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _feed_chunks(slam, feed, k):
    """The chunk-pipelined feed (``process_chunk_async``): chunk i+1's
    upload, extraction and speculative pass overlap chunk i's resolve.
    Returns the frames fed."""
    pending_img, pending_odo = [], []
    n_in = n = 0
    for img, odo in feed:
        pending_img.append(img)
        pending_odo.append(odo)
        if len(pending_img) == k:
            r = slam.process_chunk_async(pending_img, pending_odo)
            n_in += len(pending_img)
            pending_img, pending_odo = [], []
            if r is not None:
                n += len(r)
                if n % (k * 8) == 0:
                    print(f"frame {n}: kfs={len(slam.kf_frame_ids)}")
    if pending_img:
        r = slam.process_chunk_async(pending_img, pending_odo)
        n_in += len(pending_img)
        n += 0 if r is None else len(r)
    n += len(slam.flush_chunk_async())
    if n != n_in:
        raise RuntimeError(f"the chunk pipeline returned {n} poses for {n_in} frames")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", nargs="?", help="DatasetRoom-format directory")
    ap.add_argument("--cam", default=None, help="CamConfig.yml path")
    ap.add_argument("--settings", default=None, help="Settings.yml path")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--out", default="./slam_out")
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="write frame-debug and map images every N keyframes and record "
                         "per-BA chi2 logs (needs matplotlib and PIL)")
    ap.add_argument("--resume", metavar="MAP_DIR", default=None,
                    help="continue SLAM on a saved map (relocalizes the first frame; the "
                         "reference's USE_PREV_MAP)")
    ap.add_argument("--chunk", type=int, default=0, metavar="K",
                    help="chunked tracking: K frames per keyframe-decision read "
                         "(SlamSystem.process_chunk_async)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..io import DatasetRoom, SyntheticWorld, ate_se2
    from ..system import SlamSystem

    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        cfg = synthetic_cfg()
        world = SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=1)
        feed = world.sequence(args.frames, noise=(0.003, 0.002, 0.001))
    else:
        if not args.dataset:
            ap.error("dataset directory or --synthetic required")
        cfg = dataset_cfg(args.dataset, args.cam, args.settings)
        feed = iter(DatasetRoom(args.dataset, count=args.frames))

    enable_loops = not args.no_loops
    if args.resume:
        slam = SlamSystem.resume(cfg, args.resume, enable_loops=enable_loops,
                                 device=args.device)
        print(f"resumed map with {slam.n_keyframes()} keyframes")
    else:
        slam = SlamSystem(cfg, enable_loops=enable_loops, device=args.device)
    if args.viz_every > 0:
        slam.enable_viz(os.path.join(args.out, "viz"), args.viz_every)
    t0 = time.perf_counter()
    n = 0
    if args.chunk > 1:
        n = _feed_chunks(slam, feed, args.chunk)
    else:
        for img, odo in feed:
            slam.process(img, odo)
            n += 1
            if n % 50 == 0:
                print(f"frame {n}: pose={slam.current_pose()} "
                      f"kfs={slam.n_keyframes()} mps={slam.n_map_points()}")
    dt = time.perf_counter() - t0
    print(f"\n{n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)")
    print(f"keyframes={slam.n_keyframes()} map_points={slam.n_map_points()}")
    if slam._loop_closer is not None:
        print(f"loops_closed={slam._loop_closer.n_loops_closed}")
    if slam.ba_log:
        log_path = os.path.join(args.out, "ba_log.jsonl")
        with open(log_path, "w") as f:
            for rec in slam.ba_log:
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {log_path} ({len(slam.ba_log)} BA records)")

    traj_path = os.path.join(args.out, "se2lam_kf_trajectory.txt")
    slam.save_kf_trajectory(traj_path)
    print(f"wrote {traj_path}")
    # with a vocabulary (the loop closer's, or one trained now), so the
    # saved map supports relocalization
    slam.save_map(os.path.join(args.out, "map"))
    print(f"wrote {os.path.join(args.out, 'map')}")

    est = np.asarray([p for _, p in slam.trajectory]).reshape(-1, 3)
    named = {"slam": est[:, :2]}
    if not args.synthetic:
        gt_path = os.path.join(args.dataset, "gt.txt")
        if os.path.exists(gt_path) and len(est) >= 2:
            gt = np.atleast_2d(np.loadtxt(gt_path))
            # a hand-made gt.txt may be shorter than the sequence: both
            # sides are cut to the common prefix
            n_common = min(len(est), len(gt))
            gt = gt[:n_common]
            named["ground truth"] = gt[:, :2]
            rmse, _ = ate_se2(est[:n_common, :2], gt[:, :2])
            corr = slam.corrected_trajectory()
            n_corr = min(len(corr), len(gt))
            rmse_c, _ = ate_se2(corr[:n_corr, 1:3], gt[:n_corr, :2])
            print(f"ATE (SE2-aligned RMSE): {rmse:.4f} m live, {rmse_c:.4f} m retro-corrected")
            with open(os.path.join(args.out, "ate.json"), "w") as f:
                json.dump({"ate_live_m": round(float(rmse), 4),
                           "ate_corrected_m": round(float(rmse_c), 4),
                           "frames": int(len(est)), "keyframes": slam.n_keyframes()}, f)
    else:
        gt = world.gt[: len(est)]
        named["ground truth"] = gt[:, :2]
        if args.resume:
            # a resumed run is in the saved map's gauge; frames before the
            # relocalization have no anchor and are left out
            localized = {fid for fid, _, _ in slam._frame_anchors}
            ok = np.asarray([fid in localized for fid, _ in slam.trajectory])
            if ok.sum() >= 2:
                rmse, _ = ate_se2(est[ok, :2], gt[ok, :2])
                print(f"ATE (SE2-aligned, localized frames only): {rmse:.4f} m")
        else:
            rmse, _ = ate_se2(est[:, :2], gt[:, :2])
            print(f"ATE (SE2-aligned RMSE): {rmse:.4f} m")
    if have_matplotlib():
        from .. import viz

        viz.plot_trajectories(os.path.join(args.out, "trajectory.png"), named)
        viz.plot_map(os.path.join(args.out, "map.png"), slam.ms)
        print(f"wrote {args.out}/trajectory.png, {args.out}/map.png")
    else:
        print("plots skipped: matplotlib is not installed")
    return slam


if __name__ == "__main__":
    main()
