"""Fleet localization's checks (``chip_smoke.py`` phase 16) over fresh
mapping runs on the card.

Each run maps the bench world's first 60 frames as phase 8 does
(``chip_smoke.run_slam``, RANSAC seed 0: the map moves from run to run,
local BA's float ``index_add_`` adding in another order), saves and
reloads it, and runs phase 16 (``chip_smoke.fleet_localization_run`` and
its checks, ``fleet_loc_ok``) on it: every
robot of the 4-robot fleet bitwise itself in a fleet of one, the fleet of
one within 1e-3 of ``Localizer.process_chunk`` chunk by chunk, and the
old whole-run difference. One JSON line a run, then a summary.

``--stages`` first compares, on the first run's map, the stages of one
tracked localization step (the projection and match, the pose-only solve,
the whole step) under ``torch.vmap`` at B = 4 against B = 1 and against
the unbatched call, robot by robot: the elements that differ bitwise. Usage, on a machine with a
CUDA card::

    python3 examples/torch_fleet_loc_draws.py --runs 10 [--stages]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from se2lam_tpu_torch import localizer as L  # noqa: E402
from se2lam_tpu_torch import tracking  # noqa: E402
from se2lam_tpu_torch.entry import default_cfg  # noqa: E402
from se2lam_tpu_torch.io import load_map  # noqa: E402
from se2lam_tpu_torch.io.synthetic import SyntheticWorld  # noqa: E402
from se2lam_tpu_torch.solver.poseonly import solve_pose_only  # noqa: E402


def stage_trace(cfg, world, ms):
    """Robot r's outputs of each stage at B = 4 against B = 1 (vmap), and
    against the unbatched call."""
    dev = torch.device("cuda")
    ext = L.OrbExtractor(L.OrbConfig(height=cfg.height, width=cfg.width,
                                     n_features=cfg.cap.n_features,
                                     scale_factor=cfg.scale_factor, n_levels=cfg.max_level),
                         device=dev)
    gt = world.circle_trajectory(352, radius=2.5)[:cs.MAP_FRAMES]
    starts = cs.FLEET_LOC_STARTS
    feats = [ext(torch.from_numpy(world.render(gt[s + 1])).to(dev)) for s in starts]
    feats = type(feats[0])(*(torch.stack(x) for x in zip(*feats)))
    pred = torch.from_numpy(np.stack([cs.se2_minus_np(gt[s + 1], gt[0]) for s in starts])
                            .astype(np.float32)).to(dev)
    c = tracking.constants(cfg, dev)

    def step(p, f):
        return L._localize_step(ms, p, p, f, p, 10, cfg)

    def project(p, f):
        with L.fixed_order.forced(dev.type == "cuda"):
            return L._project_and_match(ms, f, p, cfg)

    def solve(p, f, fm):
        m = fm.clamp(min=0).long()
        with L.fixed_order.forced(dev.type == "cuda"):
            return solve_pose_only(p, ms.mp_pos[m], f.xy, fm >= 0, c["cam"], c["Tcb"],
                                   iters=30)

    fm4, _ = torch.vmap(project)(pred, feats)
    stages = dict(match=lambda p, f, fm: project(p, f), pose_only=solve,
                  step=lambda p, f, fm: step(p, f))
    out = {}
    for name, fn in stages.items():
        b4 = torch.vmap(fn)(pred, feats, fm4)
        b4 = b4 if isinstance(b4, tuple) else (b4,)
        diffs, solo = [], []
        for r in range(len(starts)):
            fr = type(feats)(*(x[r:r + 1] for x in feats))
            one = torch.vmap(fn)(pred[r:r + 1], fr, fm4[r:r + 1])
            one = one if isinstance(one, tuple) else (one,)
            diffs.append([int((a[r] != b[0]).sum()) for a, b in zip(b4, one)])
            u = fn(pred[r], type(feats)(*(x[0] for x in fr)), fm4[r])
            u = u if isinstance(u, tuple) else (u,)
            solo.append([int((a[r] != b).sum()) for a, b in zip(b4, u)])
        out[name] = dict(b1=diffs, unbatched=solo)
        print("STAGE " + json.dumps({name: diffs, "unbatched": solo}), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--stages", action="store_true")
    a = ap.parse_args()
    cs.phase_build()
    cfg, _ = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:cs.MAP_FRAMES]
    odo = world.odometry(gt, noise=cs.ODO_NOISE, seed=1)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    cs.MAP_DIR.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(a.runs):
        t0 = time.perf_counter()
        slam, _ = cs.run_slam(cfg, imgs, odo, gt, seed=0)
        with tempfile.TemporaryDirectory(dir=cs.MAP_DIR.parent) as d:
            slam.save_map(d)
            ms, vocab, _ = load_map(d)
        if a.stages and i == 0:
            stage_trace(cfg, world, ms)
        run, _ = cs.fleet_localization_run(cfg, world, ms, vocab)
        row = dict(run=i, ok=bool(cs.fleet_loc_ok(run)), seconds=time.perf_counter() - t0, **{
            k: run[k] for k in ("fleet_bitwise_fleet_of_one", "pose_max_diff_chunkwise",
                                "flags_equal_chunkwise", "pose_max_diff_whole_run", "tracked",
                                "k2_launches_per_chunk")})
        rows.append(row)
        print("RUN " + json.dumps(row), flush=True)
    print("SUMMARY " + json.dumps(dict(
        runs=len(rows), passed=sum(r["ok"] for r in rows),
        chunkwise_max=[r["pose_max_diff_chunkwise"] for r in rows],
        whole_run_max=[r["pose_max_diff_whole_run"] for r in rows],
        card=cs.phase_device())), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
