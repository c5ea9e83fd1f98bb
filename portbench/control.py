"""The control of a cell's check: each compared number read once from the
program and once from the reference put in the program's place in the
precision below the configuration's (TF32 products for the extractor and
K3's reduction, a float16 window test for K2, a bfloat16 pose-only solve),
with the same measure, on several seeds. A sound check passes the first
and fails the second. Not part of a benchmark run.

    python portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 20
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench.bench import run_cell

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False, control=True)
        rows.append(dict(seed=seed, program={k: c["value"] for k, c in r["checks"].items()},
                         control=r["control"], state_unchanged=r["state_unchanged"],
                         limits={k: c["limit"] for k, c in r["checks"].items()}))
        print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
