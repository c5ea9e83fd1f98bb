"""Instrumented no-loop mapping run: where does the map go bad (the port of
the JAX package's ``examples/study_noloop_debug.py``).

Runs the drift study's world without loop closing and, at every keyframe
insertion, measures against ground truth:

  - each keyframe's position error right after the insertion and its BA
    (does an early keyframe get dragged, or does error build at the
    frontier?);
  - the map points' error to the nearest ground-truth landmark (median,
    p90, phantoms, duplicates), for all points and for those the new
    keyframe observes;
  - the new keyframe's associations (right or wrong landmark), and the BA
    log of the insertion.

Variants isolate the mechanism: ``--local-iter 0`` (no BA: the keyframe
chain is pure odometry), ``--laps 1`` (before any revisit),
``--no-proj`` / ``--proj-win`` (projection re-association off, or its
window widened).

Usage:
    python -m se2lam_tpu_torch.drivers.study_noloop_debug [--laps 1]
        [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the summary dict (written to
``--out``/debug.json when ``--out`` is given).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from .study_drift import build_cfg, lap_sequence


def se2_mat(p):
    c, s = np.cos(p[2]), np.sin(p[2])
    T = np.eye(3)
    T[:2, :2] = [[c, -s], [s, c]]
    T[0, 2], T[1, 2] = p[0], p[1]
    return T


def mp_error_stats(mp_pos, mp_valid, landmarks):
    """Median / p90 distance of valid map points to their nearest
    ground-truth landmark, and the phantom (no landmark within 0.5 m) and
    duplicate (a landmark claimed by two points) counts."""
    pos = mp_pos[mp_valid]
    if len(pos) == 0:
        return dict(n=0)
    d = np.linalg.norm(pos[:, None, :] - landmarks[None, :, :], axis=-1)
    nearest = d.argmin(1)
    dmin = d.min(1)
    claimed = nearest[dmin < 0.5]
    _, counts = np.unique(claimed, return_counts=True)
    return dict(
        n=int(len(pos)),
        med=float(np.median(dmin)),
        p90=float(np.quantile(dmin, 0.9)),
        phantom=int((dmin > 0.5).sum()),
        dup=int((counts > 1).sum()),
    )


@contextlib.contextmanager
def projection_variant(no_proj=False, proj_win=0.0):
    """Within it, local mapping's projection re-association is off
    (``no_proj``) or searches a ``proj_win``-px window."""
    from .. import localmap as lm

    orig = lm.match_by_projection_streamed
    if no_proj:
        def patched(feats, uv, octv, desc, cand, feat_free, level_offset=2):
            N = feats.xy.shape[0]
            dev = feats.xy.device
            return (torch.full((N,), -1, dtype=torch.int32, device=dev),
                    torch.zeros((), dtype=torch.int32, device=dev))
    elif proj_win > 0:
        def patched(feats, uv, octv, desc, cand, feat_free, level_offset=2):
            return orig(feats, uv, octv, desc, cand, feat_free, win_size=proj_win,
                        level_offset=level_offset)
    else:
        patched = orig
    lm.match_by_projection_streamed = patched
    try:
        yield
    finally:
        lm.match_by_projection_streamed = orig


def association_counts(cfg, landmarks, gt_pose, feat_xy, obs_row, mp_pos):
    """(right, wrong) associations of a keyframe: a feature's landmark is
    the nearest ground-truth projection within 3 px; the association is
    wrong when its map point lies over 0.5 m from that landmark."""
    Twb = np.eye(4)
    c, s = np.cos(gt_pose[2]), np.sin(gt_pose[2])
    Twb[:2, :2] = [[c, -s], [s, c]]
    Twb[0, 3], Twb[1, 3] = gt_pose[0], gt_pose[1]
    Tcw = np.asarray(cfg.Tcb_mat) @ np.linalg.inv(Twb)
    pc = (Tcw[:3, :3] @ landmarks.T).T + Tcw[:3, 3]
    zv = pc[:, 2] > 0.3
    uu = cfg.fx * pc[:, 0] / np.where(zv, pc[:, 2], 1) + cfg.cx
    vv = cfg.fy * pc[:, 1] / np.where(zv, pc[:, 2], 1) + cfg.cy
    lm_uv = np.stack([uu, vv], -1)
    lm_uv[~zv] = 1e9
    n_ok = n_wrong = 0
    for fi in np.nonzero(obs_row >= 0)[0]:
        d2 = np.linalg.norm(lm_uv - feat_xy[fi], axis=-1)
        li = d2.argmin()
        if d2[li] > 3.0:
            continue
        if np.linalg.norm(mp_pos[obs_row[fi]] - landmarks[li]) > 0.5:
            n_wrong += 1
        else:
            n_ok += 1
    return n_ok, n_wrong


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--laps", type=float, default=1.0)
    ap.add_argument("--frames-per-lap", type=int, default=90)
    ap.add_argument("--noise", type=float, nargs=3,
                    default=(0.012, 0.006, 0.006))
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--odo-seed", type=int, default=3)
    ap.add_argument("--local-iter", type=int, default=6)
    ap.add_argument("--obs-sigma", type=float, default=1.0,
                    help="keypoint sigma calibration (cfg.obs_sigma_px)")
    ap.add_argument("--no-proj", action="store_true",
                    help="disable stage (c) projection re-association")
    ap.add_argument("--proj-win", type=float, default=0.0,
                    help="override stage (c) projection search window "
                         "(px at octave 1; default = matcher's 15)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args):
    from ..io import SyntheticWorld, ate_se2
    from ..system import SlamSystem

    cfg = build_cfg()
    if args.local_iter != cfg.local_iter:
        cfg = cfg.replace(local_iter=args.local_iter)
    if args.obs_sigma != 1.0:
        cfg = cfg.replace(obs_sigma_px=args.obs_sigma)
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=args.seed)
    gt = lap_sequence(world, args.laps, args.frames_per_lap)
    odo = world.odometry(gt, noise=tuple(args.noise), seed=args.odo_seed)
    ate_odo, _ = ate_se2(odo[:, :2], gt[:, :2])
    print(f"odometry ATE {ate_odo:.4f}")

    def host(x):
        return x.detach().cpu().numpy()

    slam = SlamSystem(cfg, enable_loops=False, device=args.device)
    slam.log_ba = True
    kf_err_hist = []      # (frame, per-KF position errors over all valid KFs)
    last_nkf = 0
    with projection_variant(args.no_proj, args.proj_win):
        for i in range(len(gt)):
            slam.process(world.render(gt[i]), odo[i])
            nkf = slam.n_keyframes()
            if nkf == last_nkf:
                continue
            last_nkf = nkf
            ms = slam.ms
            # gauge: the map frame is anchored at the first frame's pose
            # (the origin); T maps map -> world
            T = se2_mat(gt[0])
            kf_pose = host(ms.kf_pose)
            kf_valid = host(ms.kf_valid)
            kf_xy = (T[:2, :2] @ kf_pose[:, :2].T).T + T[:2, 2]
            mp_pos = host(ms.mp_pos)
            mp_xy = (T[:2, :2] @ mp_pos[:, :2].T).T + T[:2, 2]
            mp_pos = np.concatenate([mp_xy, mp_pos[:, 2:]], axis=1)
            mp_valid = host(ms.mp_valid)
            good_prl = host(ms.mp_good_prl)
            errs = [float(np.linalg.norm(kf_xy[slot] - gt[fid, :2]))
                    for slot, fid in enumerate(slam.kf_frame_ids)
                    if slot < len(kf_valid) and kf_valid[slot]]
            mstats = mp_error_stats(mp_pos, mp_valid, world.landmarks)
            # the points the new keyframe observes constrain the live pose
            kf_slot = nkf - 1
            obs_row = host(ms.kf_obs_mp[kf_slot])
            cur_mask = np.zeros(len(mp_valid), bool)
            cur_mask[obs_row[obs_row >= 0]] = True
            gstats = mp_error_stats(mp_pos, mp_valid & good_prl & cur_mask, world.landmarks)
            ba = slam.ba_log[-1] if slam.ba_log else {}
            kf_err_hist.append((i, errs))
            n_ok, n_wrong = association_counts(cfg, world.landmarks, gt[i],
                                               host(ms.kf_xy[kf_slot]), obs_row, mp_pos)
            odo_err = float(np.linalg.norm(odo[i, :2] - gt[i, :2]))
            print(
                f"f{i:3d} KF{nkf - 1:2d} odo={odo_err:.3f} "
                f"kf_err last={errs[-1]:.3f} "
                f"max={max(errs):.3f} mean={np.mean(errs):.3f} | "
                f"mp n={mstats.get('n', 0)} med={mstats.get('med', 0):.3f} "
                f"p90={mstats.get('p90', 0):.3f} "
                f"ph={mstats.get('phantom', 0)} dup={mstats.get('dup', 0)} "
                f"| cur n={gstats.get('n', 0)} "
                f"med={gstats.get('med', 0):.3f} "
                f"p90={gstats.get('p90', 0):.3f} "
                f"| assoc ok={n_ok} wrong={n_wrong} | ba={ba}", flush=True)

    live = np.asarray([p for _, p in slam.trajectory])
    corr = slam.corrected_trajectory()[:, 1:]
    ate_live, _ = ate_se2(live[:, :2], gt[: len(live), :2])
    ate_corr, _ = ate_se2(corr[:, :2], gt[: len(corr), :2])
    print(f"slam_noloop local_iter={args.local_iter} "
          f"ATE live {ate_live:.4f} corrected {ate_corr:.4f} "
          f"(odo {ate_odo:.4f}) kfs={slam.n_keyframes()} "
          f"mps={slam.n_map_points()}")
    out = {"local_iter": args.local_iter, "ate_live": float(ate_live),
           "ate_corrected": float(ate_corr), "ate_odo": float(ate_odo),
           "n_kfs": int(slam.n_keyframes()), "n_mps": int(slam.n_map_points()),
           "kf_err_hist": kf_err_hist}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "debug.json"), "w") as f:
            json.dump(out, f)
    return out


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
