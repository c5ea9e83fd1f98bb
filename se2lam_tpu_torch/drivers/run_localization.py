"""Localization-only driver, the reference's LOCALIZATION_ONLY mode
(src/OdoSLAM.cpp:120-132): load a saved map and localize a fresh feed
against it, writing the per-frame trajectory CSV.

Usage:
    python -m se2lam_tpu_torch.drivers.run_localization <map_dir> <dataset_dir>
        [--frames N] [--chunk K] [--out outdir] [--device cpu]
    python -m se2lam_tpu_torch.drivers.run_localization <map_dir> --synthetic

``main(argv)`` returns the ``Localizer`` it ran.
"""
from __future__ import annotations

import argparse
import os

from .run_dataset import dataset_cfg, synthetic_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map_dir")
    ap.add_argument("dataset", nargs="?")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--cam", help="CamConfig.yml (default: <dataset>/../)")
    ap.add_argument("--settings", help="Settings.yml (default: <dataset>/../)")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--out", default="./loc_out")
    ap.add_argument("--chunk", type=int, default=0, metavar="K",
                    help="chunked localization: K frames per read while tracked "
                         "(Localizer.process_chunk)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..io import DatasetRoom, SyntheticWorld, load_map
    from ..localizer import Localizer

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    ms, vocab, info = load_map(args.map_dir, dev)
    print(f"loaded map: {info['n_kf']} KFs, vocab={'yes' if vocab else 'no'}")

    if args.synthetic:
        cfg = synthetic_cfg()
        world = SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=1)
        feed = world.sequence(args.frames, noise=(0.003, 0.002, 0.001), seed=7)
    else:
        if not args.dataset:
            ap.error("dataset directory or --synthetic required")
        # the dataset's own intrinsics: synthetic ones against a real
        # dataset would localize nothing
        cfg = dataset_cfg(args.dataset, args.cam, args.settings)
        feed = iter(DatasetRoom(args.dataset, count=args.frames))

    loc = Localizer(cfg, ms, vocab, device=dev)
    n_ok = 0
    if args.chunk > 1:
        pending = []
        for item in feed:
            pending.append(item)
            if len(pending) == args.chunk:
                res = loc.process_chunk([f[0] for f in pending], [f[1] for f in pending])
                n_ok += sum(p is not None for p in res)
                pending = []
                print(f"frame {loc.frame_id}: localized={n_ok}")
        if pending:
            res = loc.process_chunk([f[0] for f in pending], [f[1] for f in pending])
            n_ok += sum(p is not None for p in res)
    else:
        for i, (img, odo) in enumerate(feed):
            p = loc.process(img, odo)
            n_ok += p is not None
            if (i + 1) % 25 == 0:
                print(f"frame {i + 1}: localized={n_ok} pose={p}")
    out = os.path.join(args.out, "localizer_trajectory.csv")
    loc.save_trajectory(out)
    print(f"localized {n_ok}/{loc.frame_id} frames → {out}")
    return loc


if __name__ == "__main__":
    main()
