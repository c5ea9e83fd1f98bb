"""How far two of ``chip_smoke.py``'s checks wander from run to run on the
card, where float scatter-adds (local BA's ``index_add_``) add in another
order every run. Run from the root of a checkout (or of another commit's,
with this file copied there) on a machine with a CUDA card.

``--ba N``: the dry run's local BA (``entry.dryrun_multichip`` step 1: K
64, M 2048, P 8, 3 LM steps) N times a mode, in the default mode and in
deterministic mode: the largest pose and point differences between two
single-device solves, two solves on a 4-block mesh of the card, and the
mesh against the single device. Deterministic mode needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment.

``--merge N``: phase 20's joint-GBA check on N fresh merge-scene maps
(robot A's and B's maps built anew, merged with generator 42): K3's and
the f32 einsum pair's error from the plain version in f64, relative to
max|S|, and whether K3's is over ``JOINT_SCHUR_REL_MAX``.

One JSON line a repetition::

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 examples/torch_check_spread.py --ba 4
    python3 examples/torch_check_spread.py --merge 4 --tag parent
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from se2lam_tpu_torch import loopclose, mapmerge, tracking  # noqa: E402
from se2lam_tpu_torch.ops.camera import CameraModel  # noqa: E402
from se2lam_tpu_torch.solver import ba  # noqa: E402
from se2lam_tpu_torch.solver import schur as K3  # noqa: E402


def ba_spread(n):
    from se2lam_tpu_torch.parallel import make_mesh, sharded_solve_local_ba

    dev = torch.device("cuda")
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device=dev)
    Tcb = torch.tensor([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                       dtype=torch.float32, device=dev)
    mesh = make_mesh(4, device="cuda")

    def d(a, b):
        return float((a - b).abs().max())

    for mode in ("default", "deterministic"):
        ctx = cs.deterministic() if mode == "deterministic" else contextlib.nullcontext()
        with ctx:
            for rep in range(n):
                prob, _ = ba.synthetic_grid_ba(np.random.default_rng(0), 64, 2048, 8, cam, Tcb)
                cfg = ba.BAConfig(iters=3)
                s1, s2 = (ba.solve_local_ba(prob, cam, Tcb, cfg) for _ in range(2))
                d1, d2 = (sharded_solve_local_ba(prob, cam, Tcb, cfg, mesh) for _ in range(2))
                print("BA " + json.dumps(dict(
                    mode=mode, rep=rep, single_single=(d(s1[0], s2[0]), d(s1[1], s2[1])),
                    dist_dist=(d(d1[0], d2[0]), d(d1[1], d2[1])),
                    dist_single=(d(d1[0], s1[0]), d(d1[1], s1[1])))), flush=True)


def merge_spread(n, tag):
    dev = torch.device("cuda")
    cfg, _world, _gt, segment = cs.merge_scene()
    seg_a, seg_b = segment(cs.MERGE_A), segment(cs.MERGE_B)
    for i in range(n):
        slam_a, slam_b = cs.build_map(cfg, *seg_a), cs.build_map(cfg, *seg_b)
        with cs.Counted(mapmerge, "run_global_ba_joint") as jg:
            mapmerge.merge_maps(slam_a.ms, slam_b.ms, cfg,
                                generator=torch.Generator(device=dev).manual_seed(42))
        (ms_in, cfg_in), kw = jg.first[0][:2], jg.first[1]
        c = tracking.constants(cfg_in, dev)
        prob = loopclose._joint_problem(ms_in, cfg_in)
        bc = loopclose._joint_ba_cfg(ms_in, cfg_in, kw.get("iters", cfg_in.gm_joint_ba_iters))
        _, _, Hpx, Hxx_inv, _, _ = ba.damped_system(prob, c["cam"], c["Tcb"], bc,
                                                    torch.tensor(bc.lm_init_lambda, device=dev))
        want = K3.point_reduction_plain(Hpx.double(), Hxx_inv.double())
        s = float(want.abs().max())
        k3 = float((K3.point_reduction(Hpx, Hxx_inv).double() - want).abs().max()) / s
        es = float((K3.point_reduction_plain(Hpx, Hxx_inv).double() - want).abs().max()) / s
        print("MERGE " + json.dumps(dict(tag=tag, i=i, k3_rel=k3, einsum_rel=es,
                                         over=k3 > cs.JOINT_SCHUR_REL_MAX)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ba", type=int, default=0)
    ap.add_argument("--merge", type=int, default=0)
    ap.add_argument("--tag", default="")
    a = ap.parse_args()
    cs.phase_device()
    cs.phase_build()
    if a.ba:
        ba_spread(a.ba)
    if a.merge:
        merge_spread(a.merge, a.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
