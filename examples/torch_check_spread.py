"""How far ``chip_smoke.py``'s checks on real systems wander from run to
run on the card, where float scatter-adds (local BA's ``index_add_``) add
in another order every run. Run from the root of a checkout on a machine
with a CUDA card; to run another commit's port under this measure, copy
this file and ``chip_smoke.py`` into that commit's checkout.

Every K3 reading is ``chip_smoke.schur_readings``: the kernel's error from
the plain version in f64 against the sum of the products' magnitudes
(``abs_rel_err``, the gate, SCHUR_ABS_REL_MAX), against max|S|
(``rel_err``, F2's old measure), the f32 einsum pair's on both, the
cancellation, and the control (the largest point taken out, in units of
the bound).

``--ba N``: the dry run's local BA (``entry.dryrun_multichip`` step 1: K
64, M 2048, P 8, 3 LM steps) N times a mode, in the default mode and in
deterministic mode: the largest pose and point differences between two
single-device solves, two solves on a 4-block mesh of the card, and the
mesh against the single device, with K3's readings on the single solve's
first system (64, 2048) and on the 4 blocks' (64, 512); then N fresh runs
of phase 7's SLAM loop (draws 0..N-1) and K3's readings on the real local
BA at the last keyframe. Deterministic mode needs
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the environment.

``--merge N``: K3's readings on phase 20's joint-GBA system on N fresh
merge-scene maps (robot A's and B's maps built anew, merged with
generator 42).

``--mini-ba N``: N fresh loop-scene maps (the loop phase's draws 0..N-1)
and the 2-KF mini-BA constraint on each one's first closure: twice on the
card, once on the CPU (``chip_smoke.mini_ba_cpu_diff``), and K3's readings
on its first system.

One JSON line a repetition::

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 examples/torch_check_spread.py --ba 4
    python3 examples/torch_check_spread.py --merge 4 --tag parent
    python3 examples/torch_check_spread.py --mini-ba 5
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
from se2lam_tpu_torch.io.synthetic import SyntheticWorld  # noqa: E402
from se2lam_tpu_torch.ops.camera import CameraModel  # noqa: E402
from se2lam_tpu_torch.solver import ba  # noqa: E402


def readings(Hpx, Hxx_inv):
    out = cs.schur_readings(Hpx, Hxx_inv)
    return dict(out, ok=cs.schur_readings_ok(out))


def ba_spread(n, tag):
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
                single, blocks = cs.schur_spy((64, 2048), 1), cs.schur_spy((64, 512), 4)
                with cs.spied_schur(single):
                    s1, s2 = (ba.solve_local_ba(prob, cam, Tcb, cfg) for _ in range(2))
                with cs.spied_schur(blocks):
                    d1, d2 = (sharded_solve_local_ba(prob, cam, Tcb, cfg, mesh) for _ in range(2))
                print("BA " + json.dumps(dict(
                    tag=tag, mode=mode, rep=rep,
                    single_single=(d(s1[0], s2[0]), d(s1[1], s2[1])),
                    dist_dist=(d(d1[0], d2[0]), d(d1[1], d2[1])),
                    dist_single=(d(d1[0], s1[0]), d(d1[1], s1[1])),
                    k3_single=readings(*single["kept"][0]),
                    k3_blocks=[readings(*b) for b in blocks["kept"]])), flush=True)

    cfg, _ = cs.default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:cs.MAP_FRAMES]
    odo = world.odometry(gt, noise=cs.ODO_NOISE, seed=1)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    for rep in range(n):
        slam, _ = cs.run_slam(cfg, imgs, odo, gt, seed=rep)
        print("LOCAL_BA " + json.dumps(dict(tag=tag, rep=rep, kf=slam._ref_kf_host,
                                            k3=readings(*cs.local_ba_system(slam, cfg)))),
              flush=True)


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
        print("MERGE " + json.dumps(dict(tag=tag, i=i, k3=readings(Hpx, Hxx_inv))), flush=True)


def mini_ba_spread(n, tag):
    world = SyntheticWorld(cs.default_cfg()[0], n_landmarks=1200, room=10.0, seed=4)
    cfg, gt, odo, imgs = cs.loop_scene(world)
    for seed in range(n):
        with cs.first_closure() as (_, closing):
            cs.run_loop(cfg, imgs, odo, gt, seed=seed)
        ms, k, cand, midx = (closing[x] for x in ("ms", "k", "cand", "match_idx"))
        spy = cs.schur_spy((2, ms.N), 1)
        with cs.spied_schur(spy):
            meas, info, n_good, _ = loopclose.build_loop_constraint_ba(ms, k, cand, midx, cfg)
        meas2, info2, n_good2, _ = loopclose.build_loop_constraint_ba(ms, k, cand, midx, cfg)
        out = dict(tag=tag, seed=seed, k=int(k), cand=int(cand), n_pairs=int((midx >= 0).sum()),
                   n_good=int(n_good), meas=meas.tolist(),
                   card_n_good_diff=abs(int(n_good) - int(n_good2)),
                   card_meas_diff=float((meas - meas2).abs().max()),
                   card_info_rel_diff=float((info - info2).abs().max() / info.abs().max()),
                   k3=readings(*spy["kept"][0]),
                   **cs.mini_ba_cpu_diff(cfg, closing, meas, info, n_good))
        print("MINI_BA " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ba", type=int, default=0)
    ap.add_argument("--merge", type=int, default=0)
    ap.add_argument("--mini-ba", type=int, default=0)
    ap.add_argument("--tag", default="")
    a = ap.parse_args()
    cs.phase_device()
    cs.phase_build()
    if a.ba:
        ba_spread(a.ba, a.tag)
    if a.merge:
        merge_spread(a.merge, a.tag)
    if a.mini_ba:
        mini_ba_spread(a.mini_ba, a.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
