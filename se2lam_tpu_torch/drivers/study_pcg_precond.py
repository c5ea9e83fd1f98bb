"""Iteration-count study of the chain-aware PCG for bank-scale joint BA
(the port of the JAX package's ``examples/study_pcg_precond.py``).

The distributed joint full-map solver (``parallel/dist_ba.py``,
``sharded_solve_joint_ba``) replaces the dense reduced-camera solve
(O(K^2) memory, O(K^3) operations per LM step) with a matrix-free PCG. The
reduced system of a K-pose odometry chain conditions as O(K^2), which
block-Jacobi cannot see: this study measures the pose error against
ground truth as a function of the inner CG steps for the block-tridiagonal
(chain-exact) preconditioner, block-Jacobi and none, at bank scale
(default K = 2048, M = 65,536, P = 6), then the edge-sharded pose graph at
K = 1024 against the dense solve.

``--blocks n`` splits the mesh into n blocks of the one device (the JAX
study's virtual CPU devices; 8 in its recorded run).

Usage:
    python -m se2lam_tpu_torch.drivers.study_pcg_precond [--blocks 4]
        [--cg 8 16 32 64 128] [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the results dict they write; each
row's ``wall_s`` is the host's clock around the solve, ending in a
synchronise.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

PG_K = 1024
PG_LOOPS = [(0, PG_K - 40), (20, PG_K - 10), (100, PG_K - 1)]
PG_ITERS = 20


def wrapped_err(p, ref):
    """max |p - ref| with the heading difference wrapped (the solver
    normalizes angles; a heading past pi would otherwise read as 2 pi)."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    d = host(p) - host(ref)
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    return float(np.abs(d).max())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--K", type=int, default=2048)
    ap.add_argument("--M", type=int, default=65536)
    ap.add_argument("--P", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cg", type=int, nargs="*",
                    default=[8, 16, 32, 64, 128])
    ap.add_argument("--out", default="artifacts/torch_pcg_precond")
    ap.add_argument("--blocks", type=int, default=8,
                    help="mesh blocks on the one device")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def joint_rows(prob, gt_poses, cam, Tcb, cfg, mesh, cgs, P):
    """``sharded_solve_joint_ba`` on ``prob`` for each preconditioner and
    inner CG count: rows of the pose error against ``gt_poses`` and the
    wall time."""
    from ..parallel import sharded_solve_joint_ba

    dev = Tcb.device
    rows = []
    for pc in ("tridiag", "jacobi", "none"):
        for cg in cgs:
            t0 = time.perf_counter()
            p, _, _ = sharded_solve_joint_ba(prob, cam, Tcb, cfg, mesh, cg_iters=cg,
                                             grid_p=P, precond=pc)
            _sync(dev)
            dt = time.perf_counter() - t0
            err = wrapped_err(p, gt_poses)
            rows.append({"precond": pc, "cg_iters": cg, "pose_err": err, "wall_s": round(dt, 3)})
            print(f"{pc:>8} cg={cg:>4}: max pose err {err:.2e} ({dt:.1f}s)", flush=True)
    return rows


def posegraph_rows(pg, pg_ref, mesh, cgs):
    """``dist_solve_pose_graph`` on ``pg`` for each preconditioner and
    inner CG count: rows of the error against the dense solve ``pg_ref``
    and the wall time."""
    from ..parallel import dist_solve_pose_graph

    dev = pg.poses.device
    rows = []
    for pc in ("tridiag", "jacobi"):
        for cg in cgs:
            t0 = time.perf_counter()
            p, _ = dist_solve_pose_graph(pg, mesh, iters=PG_ITERS, cg_iters=cg, precond=pc)
            _sync(dev)
            dt = time.perf_counter() - t0
            err = wrapped_err(p, pg_ref)
            rows.append({"precond": pc, "cg_iters": cg, "err_vs_dense": err,
                         "wall_s": round(dt, 3)})
            print(f"{pc:>8} cg={cg:>4}: max pose err vs dense {err:.2e} ({dt:.1f}s)",
                  flush=True)
    return rows


def run(args):
    from ..device import resolve_device
    from ..ops.camera import CameraModel
    from ..parallel import make_mesh
    from ..solver import BAConfig
    from ..solver.ba import synthetic_grid_ba
    from ..solver.posegraph import solve_pose_graph, synthetic_pose_graph

    dev = resolve_device(args.device)
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device=dev)
    Tcb = torch.tensor([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                       dtype=torch.float32, device=dev)
    prob, gt_poses = synthetic_grid_ba(np.random.default_rng(0), args.K, args.M, args.P, cam, Tcb)
    mesh = make_mesh(args.blocks, device=dev)
    err0 = wrapped_err(prob.poses, gt_poses)
    print(f"K={args.K} M={args.M} O={args.M * args.P} on {mesh.size} blocks; "
          f"init pose err {err0:.2e}", flush=True)
    results = {"K": args.K, "M": args.M, "P": args.P, "iters": args.iters,
               "devices": mesh.size, "init_err": err0,
               "rows": joint_rows(prob, gt_poses, cam, Tcb, BAConfig(iters=args.iters), mesh,
                                  args.cg, args.P)}
    del prob, gt_poses

    # the pose graph: the chain-dominated case where the tridiagonal
    # preconditioner pays most
    pg = synthetic_pose_graph(np.random.default_rng(1), PG_K, loop_pairs=PG_LOOPS, device=dev)
    pg_ref, _ = solve_pose_graph(pg, iters=PG_ITERS)
    print(f"\npose graph K={PG_K} (chain + 3 loop edges), vs dense solve:", flush=True)
    results["posegraph"] = {"K": PG_K, "rows": posegraph_rows(pg, pg_ref, mesh, args.cg)}

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}/results.json")
    return results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
