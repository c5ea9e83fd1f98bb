"""Controlled triangulation-accuracy probe (the port of the JAX package's
``examples/study_tri_accuracy.py``).

Renders two frames at exact ground-truth poses, matches their ORB
features in a window, triangulates with the exact relative pose (DLT), and
measures each point's 3D error against the nearest ground-truth landmark.
This isolates the vision stack (keypoints, matching, DLT) from odometry
noise: large errors here mean a frontend fault; small ones put the field
errors on the odometry-relative triangulation poses.

Usage:
    python -m se2lam_tpu_torch.drivers.study_tri_accuracy [--device cpu]

Prints one line per frame gap; ``main(argv)`` and ``run(...)`` return
{gap: {n, err_med, err_p90, frac_gt_0.5m, depth_med}}.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .study_drift import build_cfg

GAPS = (2, 4, 8)
STARTS = range(0, 80, 10)


def pair_errors(cfg, world, extract, p_ref, p_cur):
    """Errors to the nearest landmark and reference-camera depths of the
    points triangulated from the frames at poses ``p_ref`` and ``p_cur``."""
    from ..frontend.matcher import match_by_window
    from ..ops import se2
    from ..ops.triangulate import triangulate

    dev = extract.device
    f_ref = extract(world.render(p_ref))
    f_cur = extract(world.render(p_cur))
    wm = match_by_window(f_ref, f_cur, f_ref.xy, win_size=40.0, nn_ratio=0.9)
    midx = wm.idx2.cpu().numpy()
    Tcb = torch.as_tensor(cfg.Tcb_mat, dtype=torch.float32, device=dev)
    Tbc = torch.as_tensor(cfg.Tbc_mat, dtype=torch.float32, device=dev)
    Kmat = torch.tensor([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1]],
                        dtype=torch.float32, device=dev)
    # the exact relative pose ref -> cur
    d_ref = se2.minus(torch.as_tensor(p_ref, dtype=torch.float32, device=dev),
                      torch.as_tensor(p_cur, dtype=torch.float32, device=dev))
    Tcr = Tcb @ se2.to_se3(d_ref) @ Tbc
    P_ref = torch.cat([Kmat, torch.zeros((3, 1), dtype=torch.float32, device=dev)], dim=1)
    P_cur = Kmat @ Tcr[:3, :]
    ok = midx >= 0
    pos_c = triangulate(f_ref.xy, f_cur.xy[torch.as_tensor(np.maximum(midx, 0), device=dev)],
                        P_ref[None], P_cur[None]).cpu().numpy()
    # reference-camera frame -> world
    Twb = np.eye(4, dtype=np.float32)
    c, s = np.cos(p_ref[2]), np.sin(p_ref[2])
    Twb[:2, :2] = [[c, -s], [s, c]]
    Twb[0, 3], Twb[1, 3] = p_ref[0], p_ref[1]
    Twc = Twb @ np.asarray(cfg.Tbc_mat, np.float32)
    pos_w = (Twc[:3, :3] @ pos_c.T).T + Twc[:3, 3]
    valid = ok & f_ref.valid.cpu().numpy() & (pos_c[:, 2] > 0.2)
    pw = pos_w[valid]
    d = np.linalg.norm(pw[:, None, :] - world.landmarks[None], axis=-1).min(1)
    return d, pos_c[valid, 2]


def run(device=None, starts=STARTS):
    from ..frontend.orb import OrbConfig, OrbExtractor
    from ..io import SyntheticWorld

    cfg = build_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    lap = world.circle_trajectory(90)
    oc = OrbConfig(height=cfg.height, width=cfg.width, n_features=256,
                   scale_factor=cfg.scale_factor, n_levels=cfg.max_level)
    extract = OrbExtractor(oc, device=device)
    out = {}
    for gap in GAPS:
        errs, depths = zip(*[pair_errors(cfg, world, extract, lap[i0], lap[i0 + gap])
                             for i0 in starts])
        errs, depths = np.concatenate(errs), np.concatenate(depths)
        out[gap] = {"n": int(len(errs)), "err_med": float(np.median(errs)),
                    "err_p90": float(np.quantile(errs, 0.9)),
                    "frac_gt_0.5m": float(np.mean(errs > 0.5)),
                    "depth_med": float(np.median(depths))}
        print(f"gap={gap}: n={len(errs)} err med={np.median(errs):.3f} "
              f"p90={np.quantile(errs, 0.9):.3f} "
              f"frac>0.5m={np.mean(errs > 0.5):.2f} "
              f"depth med={np.median(depths):.2f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
