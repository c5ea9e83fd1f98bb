"""Compare two trajectory files: association by id, SE(2)-aligned ATE.

Reads the reference's keyframe trajectory (``idKF x y z yaw`` rows,
``se2lam_kf_trajectory.txt``, src/OdoSLAM.cpp:199-214) or the Localizer's
per-frame CSV (``frame,x,y,theta``, src/Localizer.cpp:178-193), detected
from the rows, associates rows by their id column and reports the
translational ATE after the best SE(2) alignment (a monocular + odometry
run is defined up to its first pose).

Usage:
    python -m se2lam_tpu_torch.drivers.evaluate_ate EST_FILE REF_FILE
        [--no-align] [--plot out.png]

Prints one JSON line, {"ate_rmse": ..., "mean": ..., "max": ...,
"n_associated": ...}; ``main(argv)`` returns it as a dict. It runs on the
host and needs no card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def load_any(path: str) -> np.ndarray:
    """(n, 3) [id, x, y] from either trajectory format: comma rows are
    ``frame,x,y,theta``, whitespace rows ``id x y ...``. Rows without a
    finite position (a Localizer's untracked frames) are skipped."""
    rows = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split(",") if "," in ln else ln.split()
            if len(parts) < 3:
                continue
            x, y = float(parts[1]), float(parts[2])
            if np.isfinite(x) and np.isfinite(y):
                rows.append((float(parts[0]), x, y))
    if not rows:
        raise SystemExit(f"no trajectory rows in {path}")
    return np.asarray(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("est", help="estimated trajectory file")
    ap.add_argument("ref", help="reference/ground-truth trajectory file")
    ap.add_argument("--no-align", action="store_true",
                    help="skip the SE(2) alignment (files in one gauge)")
    ap.add_argument("--plot", metavar="PNG", help="write an overlay of the aligned paths "
                    "(needs matplotlib)")
    args = ap.parse_args(argv)

    from ..io.trajectory import ate_se2

    est, ref = load_any(args.est), load_any(args.ref)
    # association by id: the ids both files share are the comparable set
    ref_by_id = {int(r[0]): r[1:3] for r in ref}
    pairs = [(e[1:3], ref_by_id[int(e[0])]) for e in est if int(e[0]) in ref_by_id]
    if len(pairs) < 2:
        raise SystemExit(f"only {len(pairs)} shared ids between {args.est} and {args.ref}; "
                         "need >= 2 (association is by the id column)")
    e_xy = np.asarray([p[0] for p in pairs])
    r_xy = np.asarray([p[1] for p in pairs])
    rmse, aligned = ate_se2(e_xy, r_xy, align=not args.no_align)
    err = np.linalg.norm(aligned - r_xy, axis=1)

    if args.plot:
        from ..viz import _pyplot

        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot(r_xy[:, 0], r_xy[:, 1], "-", color="0.4", label="reference")
        ax.plot(aligned[:, 0], aligned[:, 1], "-", color="tab:blue",
                label="estimate (aligned)")
        ax.set_aspect("equal")
        ax.legend()
        ax.set_title(f"ATE RMSE {rmse:.3f} m over {len(pairs)} poses")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        plt.close(fig)

    out = {"ate_rmse": round(rmse, 6), "mean": round(float(err.mean()), 6),
           "max": round(float(err.max()), 6), "n_associated": len(pairs)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
