"""Trajectory txt IO + SE(2)-aligned ATE (the port's own numpy copy of
se2lam_tpu.io.trajectory).

The reference's comparable artifact is ``se2lam_kf_trajectory.txt`` with
``idKF x y z yaw`` rows (src/OdoSLAM.cpp:199-214); ATE against it must be
computed after an SE(2) alignment because a monocular+odometry SLAM run is
defined up to the initial frame's gauge.
"""
from __future__ import annotations

import numpy as np

__all__ = ["save_trajectory", "load_trajectory", "ate_se2"]


def save_trajectory(path: str, rows):
    """rows: (n, 5) [id x y z yaw] (reference format)."""
    rows = np.asarray(rows)
    with open(path, "w") as f:
        for r in rows:
            f.write(
                f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} {r[4]:.6f}\n"
            )


def load_trajectory(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if len(parts) >= 5:
                rows.append([float(p) for p in parts[:5]])
    return np.asarray(rows, np.float64).reshape(-1, 5)


def ate_se2(est_xy, gt_xy, align: bool = True):
    """RMSE of translational error after optimal SE(2) alignment.

    est_xy/gt_xy: (n, 2) matched positions. Returns (rmse, aligned_est).
    Closed-form 2D Umeyama (rotation + translation, no scale — odometry
    fixes metric scale in this system).
    """
    est = np.asarray(est_xy, np.float64)
    gt = np.asarray(gt_xy, np.float64)
    assert est.shape == gt.shape and est.ndim == 2
    if align and len(est) >= 2:
        mu_e = est.mean(0)
        mu_g = gt.mean(0)
        E = est - mu_e
        G = gt - mu_g
        # rotation maximizing trace(R E^T G)
        a = (E * G).sum()
        b = (E[:, 0] * G[:, 1] - E[:, 1] * G[:, 0]).sum()
        th = np.arctan2(b, a)
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]])
        est = (R @ E.T).T + mu_g
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt((err**2).mean())), est
