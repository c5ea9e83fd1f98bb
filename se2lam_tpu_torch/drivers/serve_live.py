"""Serve a live SLAM session over TCP, the reference's test_ros node
(test/test_ros.cpp:61-105) over a plain socket (protocol in
``se2lam_tpu_torch/io/liveserver.py``). Feed it with ``feed_live``, the JAX
package's ``examples/feed_live.py``, or any client of that protocol.

Usage:
    python -m se2lam_tpu_torch.drivers.serve_live [--port 7207]
        [--chunk 8 | --pipeline 4] [--device cpu]
        [--map PATH]              # resume mapping on a saved map
        [--map PATH --localize]   # localization only, the map frozen
        [--save PATH]             # save the built map at shutdown (Ctrl-C)
"""
from __future__ import annotations

import argparse


def make_system(cfg, map_path=None, localize=False, device=None):
    """The estimator the server drives: a ``Localizer`` on a frozen saved
    map, ``SlamSystem.resume`` on a saved map, or a fresh ``SlamSystem``
    with loops on."""
    from ..device import resolve_device
    from ..io import load_map
    from ..localizer import Localizer
    from ..system import SlamSystem

    dev = resolve_device(device)
    if localize:
        ms, vocab, _meta = load_map(map_path, dev)
        return Localizer(cfg, ms, vocab, device=dev)
    if map_path:
        return SlamSystem.resume(cfg, map_path, device=dev)
    return SlamSystem(cfg, enable_loops=True, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7207)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--flush-ms", type=float, default=50.0)
    ap.add_argument("--pipeline", type=int, default=None, metavar="D",
                    help="depth-D pipelined per-frame serving (process_async): replies "
                         "lag ~D frames instead of up to --chunk")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--map", default=None,
                    help="a saved map: resume mapping on it, or serve it frozen with "
                         "--localize")
    ap.add_argument("--localize", action="store_true",
                    help="with --map: localization only against the frozen map (lost "
                         "frames reply flags=0)")
    ap.add_argument("--save", default=None, help="save the map at shutdown (Ctrl-C)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.localize and not args.map:
        ap.error("--localize requires --map")

    from ..entry import default_cfg
    from ..io.liveserver import SlamServer

    cfg, _ = default_cfg(width=args.width, height=args.height, n_features=args.features)
    system = make_system(cfg, args.map, args.localize, args.device)
    server = SlamServer(system, host=args.host, port=args.port, chunk=args.chunk,
                        flush_ms=args.flush_ms, pipeline=args.pipeline)
    mode = f"pipeline={args.pipeline}" if args.pipeline is not None else f"chunk={args.chunk}"
    print(f"serving on {server.address} ({mode}); Ctrl-C stops", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        print(f"served {server.frames_served} frames")
        if args.save:
            if args.localize:
                print("--save ignored: --localize never changes the map")
            else:
                system.save_map(args.save)
                print(f"map saved to {args.save}")


if __name__ == "__main__":
    main()
