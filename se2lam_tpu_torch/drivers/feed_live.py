"""Replay a dataset into a live SLAM server, the reference's datapub
(test/datapub.cpp): DatasetRoom frames, or the synthetic world, over TCP to
``serve_live`` (or the JAX package's server), printing the returned poses.

Usage:
    python -m se2lam_tpu_torch.drivers.feed_live --synthetic --frames 200
        [--host 127.0.0.1 --port 7207] [--fps 30]
    python -m se2lam_tpu_torch.drivers.feed_live --data /path/DatasetRoom [--fps 30]

``main(argv)`` returns the replies, (frame id, pose, valid) in order. The
client needs no card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7207)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--data", default=None, help="DatasetRoom directory")
    ap.add_argument("--fps", type=float, default=0.0,
                    help="feed pacing (0 = as fast as replies allow)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args(argv)

    from ..io import DatasetRoom, SyntheticWorld
    from ..io.liveserver import LiveClient

    if args.data:
        ds_iter = iter(DatasetRoom(args.data))
        img0, odo0 = next(ds_iter)
        H, W = img0.shape

        def feed():
            yield np.asarray(img0, np.uint8), np.asarray(odo0)
            for img, odo in ds_iter:
                yield np.asarray(img, np.uint8), np.asarray(odo)
    else:
        from ..entry import default_cfg

        cfg, _ = default_cfg(width=args.width, height=args.height)
        world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
        gt = world.circle_trajectory(args.frames, radius=2.5)

        def feed():
            for i in range(args.frames):
                yield (np.asarray(world.render(gt[i]), np.uint8),
                       np.asarray(gt[i], np.float32))
        H, W = cfg.height, cfg.width

    client = LiveClient((args.host, args.port), H, W)
    period = 1.0 / args.fps if args.fps > 0 else 0.0
    n = 0
    replies = []
    t0 = time.perf_counter()

    def take(got):
        for fid, pose, ok in got:
            replies.append((fid, pose, ok))
            if fid % 50 == 0:
                print(f"frame {fid}: pose={pose}")

    try:
        for img, odo in feed():
            t_next = t0 + n * period
            now = time.perf_counter()
            if period and now < t_next:
                time.sleep(t_next - now)
            client.send_frame(img, odo)
            n += 1
            # keep the reply pipe drained so neither side blocks on a full
            # socket buffer (replies lag by up to the server's chunk)
            if n % 16 == 0:
                take(client.drain())
        take(client.drain())
    finally:
        client.close()
    dt = time.perf_counter() - t0
    print(f"fed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.1f} fps)")
    return replies


if __name__ == "__main__":
    main()
