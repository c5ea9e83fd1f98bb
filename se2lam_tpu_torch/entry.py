"""The port's entry point: the per-frame hot path, ORB extraction followed
by the tracking step, at the bench configuration (640×480, 1000 features,
5 levels, scale 1.2), on a synthetic world. The same flow as the JAX
package's ``__graft_entry__.entry``. ``dryrun_multichip`` drives every
distributed path at the shapes of the JAX package's multi-device dry run.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tracking
from .config import Capacity, SystemConfig
from .device import resolve_device
from .frontend.orb import OrbConfig, OrbExtractor
from .io.synthetic import SyntheticWorld

__all__ = ["default_cfg", "entry", "session_cfg", "dryrun_multichip"]


def default_cfg(width=640, height=480, n_features=1000, n_levels=5):
    """(SystemConfig, OrbConfig) of the bench: a rover camera looking along
    body +x, focal length 0.8·width, depth gates 0.2–30 m."""
    Tcb = np.array(
        [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
    )
    oc = OrbConfig(
        height=height, width=width, n_features=n_features,
        scale_factor=1.2, n_levels=n_levels,
    )
    cfg = SystemConfig(
        width=width, height=height,
        fx=width * 0.8, fy=width * 0.8, cx=width / 2, cy=height / 2,
        Tbc=tuple(np.linalg.inv(Tcb).ravel()),
        upper_depth=30.0, lower_depth=0.2,
        max_feature_num=n_features, max_level=n_levels,
        cap=Capacity(n_features=oc.n_slots),
    )
    return cfg, oc


def entry(device=None):
    """(step, example_args). ``step(img, ts, odo, generator=None, *,
    gumbel=None)`` extracts ORB features from ``img`` and runs one tracking
    step against ``ts``; it returns (new TrackState, TrackResult).
    ``example_args`` holds frame 1 of the synthetic world, the state seeded
    from frame 0 (no map points yet), its odometry and a seeded generator.
    ``device=None`` means CUDA and raises without a GPU."""
    dev = resolve_device(device)
    cfg, oc = default_cfg()
    extract = OrbExtractor(oc, device=dev)

    world = SyntheticWorld(cfg, n_landmarks=400, seed=0)
    img0 = torch.from_numpy(world.render(np.zeros(3, np.float32))).to(dev)
    feats0 = extract(img0)
    odo0 = torch.zeros(3, dtype=torch.float32, device=dev)
    ts = tracking.init_track_state(
        feats0, odo0, odo0, 0,
        view_mp=torch.zeros((oc.n_slots, 3), dtype=torch.float32, device=dev),
        obs_mask=torch.zeros(oc.n_slots, dtype=torch.bool, device=dev),
    )

    def step(img, ts, odo, generator=None, *, gumbel=None):
        feats = extract(img)
        return tracking.track_frame(
            ts, feats, odo, cfg, generator=generator, gumbel=gumbel
        )

    odo1 = np.asarray([0.05, 0.0, 0.01], np.float32)
    example_args = (
        torch.from_numpy(world.render(odo1)).to(dev),
        ts,
        torch.from_numpy(odo1).to(dev),
        torch.Generator(device=dev).manual_seed(0),
    )
    return step, example_args


def _wrapped_err(p, ref):
    """Largest |p − ref| over the poses, the angle wrapped."""
    d = (p - ref).double().cpu().numpy()
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    return float(np.abs(d).max())


def session_cfg():
    """The 320x240, 256-feature revisit-lap configuration of the JAX
    package's mesh session (``__graft_entry__.py:262-285``,
    ``tests/test_dist_system.py``): SystemConfig with the loop gates scaled
    to 256 features, 64 keyframe and 4096 point slots."""
    import dataclasses

    Tcb = np.array([[0, -1, 0, 0], [0, 0, -1, 0.6], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    cfg, oc = default_cfg(width=320, height=240, n_features=256, n_levels=2)
    return cfg.replace(
        fx=260.0, fy=260.0, cx=160.0, cy=120.0, Tbc=tuple(np.linalg.inv(Tcb).ravel()),
        min_frames_between_kf=2, max_frames_between_kf=8, local_iter=6, gm_joint_ba_iters=3,
        gm_dcl_min_kfid_offset=8, gm_vcl_num_min_match_mp=6, gm_vcl_num_min_match_kp=15,
        cap=dataclasses.replace(cfg.cap, n_features=oc.n_slots, max_kfs=64, max_mps=4096,
                                local_kfs=8, local_ref_kfs=8, local_mps=512,
                                ransac_trials=64))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every distributed path at the JAX package's dry-run shapes, with
    its asserts (``__graft_entry__.dryrun_multichip``), on
    ``parallel.make_mesh(n_devices, device=device)``: n cards, or n blocks
    on one device. Returns each step's seconds and figures.

    1. map-block partitioned local BA (K=64, M=2048, P=8) against the
       single-device solver (poses 1e-4, points 1e-3), descending;
    2. the edge-sharded pose graph (K=256, chain + 3 loops) against the
       dense solve (1e-3);
    3. Hamming and BoW loop scoring over a split bank;
    4. fleet tracking with the robots cut over the blocks;
    6. the matrix-free PCG joint BA against the single-device optimum at
       64/2048 (5e-3), and at bank scale (K=2048, M=65536, P=6, 393k
       observations) converging on ground truth (error < 0.5·err0 and
       < 1e-2);
    5. a mapping session on the mesh (the pipelined feed, then
       ``process``) that closes a loop with corrected ATE below
       odometry's."""
    import time

    from .io.synthetic import SyntheticWorld as SW
    from .io.trajectory import ate_se2
    from .ops.camera import CameraModel
    from .parallel import (
        dist_solve_pose_graph, make_fleet_tracker, make_mesh, shard_bank, sharded_bow_detect,
        sharded_hamming_detect, sharded_solve_joint_ba, sharded_solve_local_ba,
    )
    from .solver.ba import BAConfig, solve_local_ba, synthetic_grid_ba
    from .solver.posegraph import solve_pose_graph, synthetic_pose_graph
    from .system import SlamSystem

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    rng = np.random.default_rng(0)
    cam = CameraModel.create(500.0, 500.0, 320.0, 240.0, device=dev)
    Tcb = torch.tensor([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                       dtype=torch.float32, device=dev)
    out = {}

    def clock(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name + "_s"] = time.perf_counter() - t0
        return r

    # 1. distributed local BA at window scale
    prob, _ = synthetic_grid_ba(rng, 64, 2048, 8, cam, Tcb)
    cfg = BAConfig(iters=3)
    p_ref, x_ref, info_ref = clock("local_ba_single", lambda: solve_local_ba(prob, cam, Tcb, cfg))
    p, x, info = clock("local_ba_dist", lambda: sharded_solve_local_ba(prob, cam, Tcb, cfg, mesh))
    out["local_ba"] = dict(dropped=int(info["n_obs_dropped"]),
                           pose_diff=float((p - p_ref).abs().max()),
                           point_diff=float((x - x_ref).abs().max()),
                           chi2=float(info["chi2"]), chi2_init=float(info_ref["chi2_init"]),
                           chi2_single=float(info_ref["chi2"]))
    assert out["local_ba"]["dropped"] == 0 and bool(torch.isfinite(p).all())
    assert float(info_ref["chi2"]) < 0.5 * float(info_ref["chi2_init"]), "single BA failed to descend"
    assert out["local_ba"]["pose_diff"] < 1e-4, ("dist BA diverges", out["local_ba"])
    assert out["local_ba"]["point_diff"] < 1e-3, ("dist BA points diverge", out["local_ba"])

    # 2. distributed pose graph over a loop-closed chain
    Kp = 256
    pg = synthetic_pose_graph(rng, Kp, loop_pairs=[(0, Kp - 30), (10, Kp - 5), (40, Kp - 1)],
                              device=dev)
    pg_ref, _ = clock("pose_graph_single", lambda: solve_pose_graph(pg, iters=20))
    pg_p, _ = clock("pose_graph_dist",
                    lambda: dist_solve_pose_graph(pg, mesh, iters=20, cg_iters=48))
    out["pose_graph_diff"] = float((pg_p - pg_ref).abs().max())
    assert out["pose_graph_diff"] < 1e-3, ("dist pose graph diverges", out["pose_graph_diff"])

    # 3. loop scoring over a bank split over the mesh
    B = max(256, 64 * mesh.size)
    bank_desc = torch.from_numpy(1 - 2 * rng.integers(0, 2, (B, 256)).astype(np.int8)).to(dev)
    best, dist = sharded_hamming_detect(shard_bank(bank_desc, mesh), bank_desc[B // 2][None])
    assert int(best) == B // 2 and float(dist) == 0.0, (int(best), float(dist))
    W = 512
    bow = torch.from_numpy(np.abs(rng.normal(0, 1, (B, W))).astype(np.float32)).to(dev)
    bow = bow / bow.sum(1, keepdim=True)
    # only one row is eligible, and not the query's own
    eligible = torch.zeros(B, dtype=torch.bool, device=dev)
    eligible[B // 4] = True
    bi, _ = sharded_bow_detect(shard_bank(bow, mesh), bow[B // 3], eligible)
    assert int(bi) == B // 4, int(bi)

    # 4. fleet tracking, the robots cut over the blocks
    cfg_f, oc_f = default_cfg(width=160, height=128, n_features=64, n_levels=2)
    init_fn, step_fn, extract_fn = make_fleet_tracker(cfg_f, oc_f, mesh=mesh)
    Bf = mesh.size
    imgs = torch.from_numpy(rng.uniform(0, 255, (Bf, 128, 160)).astype(np.float32)).to(dev)
    odos = torch.zeros((Bf, 3), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = torch.stack([tracking.draw_track_noise(gen, cfg_f) for _ in range(Bf)])
    ts = init_fn(extract_fn(imgs), odos, odos)
    _, res = clock("fleet_step", lambda: step_fn(ts, imgs, odos, noise))
    assert bool(torch.isfinite(res.gather().pose).all())

    # 6. matrix-free PCG joint BA: window scale against the single optimum
    probj, _ = synthetic_grid_ba(np.random.default_rng(2), 64, 2048, 8, cam, Tcb)
    cfg8 = BAConfig(iters=8)
    pj_ref, _, _ = clock("pcg_window_single", lambda: solve_local_ba(probj, cam, Tcb, cfg8))
    pj, _, infoj = clock("pcg_window_dist", lambda: sharded_solve_joint_ba(
        probj, cam, Tcb, cfg8, mesh, cg_iters=32, grid_p=8))
    out["pcg_window_err"] = _wrapped_err(pj, pj_ref)
    assert int(infoj["n_obs_dropped"]) == 0
    assert out["pcg_window_err"] < 5e-3, ("PCG joint BA optimum diverges", out["pcg_window_err"])
    # bank scale, against ground truth
    probb, gtb = synthetic_grid_ba(np.random.default_rng(3), 2048, 65536, 6, cam, Tcb)
    err0 = _wrapped_err(probb.poses, gtb)
    pb, _, infob = clock("pcg_bank_dist", lambda: sharded_solve_joint_ba(
        probb, cam, Tcb, BAConfig(iters=4), mesh, cg_iters=16, grid_p=6))
    out["pcg_bank"] = dict(err=_wrapped_err(pb, gtb), err0=err0, K=2048, M=65536, P=6,
                           obs=int(probb.obs_kf.shape[0]))
    del probb, gtb
    assert int(infob["n_obs_dropped"]) == 0
    assert out["pcg_bank"]["err"] < 0.5 * err0 and out["pcg_bank"]["err"] < 1e-2, out["pcg_bank"]

    # 5. a mapping session on the mesh
    cfg_s = session_cfg()
    world = SW(cfg_s, n_landmarks=600, room=10.0, seed=4)
    lap = world.circle_trajectory(90)
    gt = np.concatenate([lap, lap])[:126]
    odo = world.odometry(gt, noise=(0.012, 0.006, 0.006), seed=3)
    frames = [world.render(g) for g in gt]
    slam = SlamSystem(cfg_s, enable_loops=True, mesh=mesh, device=dev)

    def session():
        # the pipelined feed over the first lap, then the synchronous one
        # for the revisit that closes the loop
        slam.pipeline_depth = 3
        for i in range(90):
            slam.process_async(frames[i], odo[i])
        slam.flush_async()
        for i in range(90, len(gt)):
            slam.process(frames[i], odo[i])
        return slam.corrected_trajectory()

    corr = clock("session", session)[:, 1:]
    lc = slam._loop_closer
    ate_c = float(ate_se2(corr[:, :2], gt[: len(corr), :2])[0])
    ate_o = float(ate_se2(odo[:, :2], gt[:, :2])[0])
    out["session"] = dict(frames=len(gt), n_kf=slam.n_keyframes(), loops=lc.n_loops_closed,
                          ate_corrected=ate_c, ate_odometry=ate_o, dist=lc._dist)
    assert lc._dist, "the mesh session must route the distributed solvers"
    assert lc.n_loops_closed >= 1, "no loop closed in the mesh session"
    assert ate_c < ate_o, (ate_c, ate_o)
    return out
