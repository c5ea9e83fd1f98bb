"""Merge two saved maps into one: cross-map place recognition, SE(2)
alignment, duplicate-landmark fusion and global BA
(``se2lam_tpu_torch.mapmerge``). The reference has no analog (MapStorage
holds one map); this is the fleet's rendezvous: robots map independently,
the maps merge, the fleet serves on the union.

Usage:
    python -m se2lam_tpu_torch.drivers.merge_maps MAP_A MAP_B --out MERGED_DIR
        [--cam CamConfig.yml --settings Settings.yml] [--device cpu]

Without the YAMLs the synthetic demo configuration is used (that of maps
from ``run_dataset --synthetic``). ``main(argv)`` returns (merged map, info).
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map_a", help="saved map dir (keeps its frame)")
    ap.add_argument("map_b", help="saved map dir (aligned into A)")
    ap.add_argument("--out", required=True, help="merged map output dir")
    ap.add_argument("--cam")
    ap.add_argument("--settings")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..config import SystemConfig
    from ..device import resolve_device
    from ..io import load_map, save_map
    from ..mapmerge import merge_maps
    from .run_dataset import synthetic_cfg

    if bool(args.cam) != bool(args.settings):
        ap.error("--cam and --settings must be given together")
    cfg = (SystemConfig.from_yaml(args.cam, args.settings) if args.cam
           else synthetic_cfg())
    dev = resolve_device(args.device)
    ms_a, _vocab_a, info_a = load_map(args.map_a, dev)
    ms_b, _, info_b = load_map(args.map_b, dev)
    print(f"A: {info_a['n_kf']} KFs; B: {info_b['n_kf']} KFs")

    # a fresh vocabulary is trained on the UNION of both maps (A's own
    # covers only A's places); the merged map is saved with it
    merged, info = merge_maps(ms_a, ms_b, cfg, device=dev)
    print(f"merged at pair A:{info['pair'][0]} B:{info['pair'][1]} "
          f"(BoW {info['bow_score']:.3f}, {info['align_inliers']} align inliers, "
          f"{info['mps_fused']} duplicate landmarks fused)")
    os.makedirs(args.out, exist_ok=True)
    save_map(args.out, merged, info["vocab"])
    print(f"wrote {args.out}: {int(merged.n_kf)} KFs")
    return merged, info


if __name__ == "__main__":
    main()
