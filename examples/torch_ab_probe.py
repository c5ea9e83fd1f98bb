"""Host-time probe of the PyTorch port on one card, for comparing two
checkouts in turns (A, B, A, B, ...): the tracking path (extraction and
``track_frame`` over 19 frames of the bench world, one ``need_kf`` read a
frame, best of 4 passes), the 30-step pose-only solve on 300 synthetic
points (best of 4 passes of 5 solves), and one eager ``windowed_top2``
call at (8192, 1000) (mean of 200 calls). Prints one line:

    AB <checkout> path_ms_per_frame <ms> pose_only_ms <ms> k2_call_us <µs>

Usage, from the repository root on a machine with a CUDA card:

    python3 examples/torch_ab_probe.py <root of the checkout to probe>

Each call builds that checkout's kernels under its own ``build/`` first.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np


def main(root: str):
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from se2lam_tpu_torch import tracking
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.frontend import windowed_match as K2
    from se2lam_tpu_torch.frontend.orb import OrbExtractor
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld
    from se2lam_tpu_torch.kernels.samples import k2_inputs
    from se2lam_tpu_torch.solver.poseonly import solve_pose_only

    dev = torch.device("cuda")
    cfg, oc = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:20]
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    ext = OrbExtractor(oc)
    N = oc.n_slots

    def path():
        g = torch.Generator(device=dev).manual_seed(0)
        ts = tracking.init_track_state(ext(imgs[0]), gt[0], gt[0], 0,
                                       torch.zeros((N, 3), device=dev),
                                       torch.zeros(N, dtype=torch.bool, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, len(imgs)):
            ts, res = tracking.track_frame(ts, ext(imgs[i]), torch.from_numpy(gt[i]).to(dev),
                                           cfg, generator=g)
            bool(res.need_kf)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (len(imgs) - 1) * 1e3

    c = tracking.constants(cfg, dev)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(np.stack([rng.uniform(2, 6, 300), rng.uniform(-2, 2, 300),
                                     rng.uniform(-1, 1, 300)], 1).astype(np.float32)).to(dev)
    uv = torch.from_numpy(rng.uniform(0, 640, (300, 2)).astype(np.float32)).to(dev)
    valid = torch.ones(300, dtype=torch.bool, device=dev)
    pose = torch.zeros(3, device=dev)

    def pose_only():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            _, _, n = solve_pose_only(pose, pts, uv, valid, c["cam"], c["Tcb"], iters=30)
            int(n)
        return (time.perf_counter() - t0) / 5 * 1e3

    x = [a.to(dev) for a in k2_inputs(8192, 1000)]
    path(), pose_only(), K2.windowed_top2(*x)            # warm-up
    path_ms = min(path() for _ in range(4))
    po_ms = min(pose_only() for _ in range(4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        K2.windowed_top2(*x)
    torch.cuda.synchronize()
    k2_us = (time.perf_counter() - t0) / 200 * 1e6
    print(f"AB {Path(root).name} path_ms_per_frame {path_ms:.3f} pose_only_ms {po_ms:.3f} "
          f"k2_call_us {k2_us:.1f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
