"""Flat-vocabulary scale ceiling: BoW score separation against map size
(the port of the JAX package's ``examples/study_vocab_scale.py``).

DBoW2 discriminates with ~1M leaf words; this system trains a flat word
bank (``vocab.py``, default W = 1024) on its own keyframes. As the
keyframe count K grows, keyframes share words and the L1 scores compress;
this study measures whether the true revisit still outscores the best
impostor, as a function of K and W.

Model: a corridor of landmarks (a pool of random 256-bit descriptors);
keyframe k observes a window of the pool (stride < window, so neighbours
share landmarks). A revisit query re-observes place q's window with
per-bit flip noise p = 0.08. The vocabulary is trained on the bank with
document idf, as the live system trains it.

Reported per (K, W): top-1 retrieval accuracy over the queries, mean and
least separation (true score - best impostor), and the impostors' mean.

Usage:
    python -m se2lam_tpu_torch.drivers.study_vocab_scale [--Ks 64 256 1024]
        [--Ws 1024 4096 16384] [--out DIR] [--device cpu]

``main(argv)`` and ``run(args)`` return the results dict they write.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def run_one(K, W, F=128, stride=64, flip=0.08, n_queries=24, seed=0, device=None,
            seed_idx=None):
    """One (K, W) cell. The vocabulary's seed rows come from a generator
    seeded ``seed`` on the device, or are given as ``seed_idx`` (a parity
    run passes the JAX package's draw)."""
    from ..device import resolve_device
    from ..vocab import bow_score, bow_transform, train_vocab

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    L = stride * (K - 1) + F
    pool = (1 - 2 * rng.integers(0, 2, (L, 256))).astype(np.int8)

    def view(q, noisy):
        d = pool[q * stride:q * stride + F].copy()
        if noisy:
            flips = rng.random((F, 256)) < flip
            d = np.where(flips, -d, d)
        return torch.from_numpy(d).to(dev)

    bank_desc = torch.stack([view(k, noisy=True) for k in range(K)])
    valid = torch.ones((K, F), dtype=torch.bool, device=dev)
    doc_ids = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(F)
    vocab = train_vocab(
        bank_desc.reshape(-1, 256), valid.reshape(-1), n_words=W, iters=5,
        generator=torch.Generator(device=dev).manual_seed(seed), seed_idx=seed_idx,
        doc_ids=doc_ids, n_docs_cap=K,
    )
    bank, _ = bow_transform(vocab, bank_desc, valid)

    seps, top1, best_imp = [], 0, []
    qs = rng.choice(np.arange(2, K - 2), size=min(n_queries, K - 4), replace=False)
    for q in qs:
        v, _ = bow_transform(vocab, view(int(q), noisy=True),
                             torch.ones((F,), dtype=torch.bool, device=dev))
        s = bow_score(bank, v).cpu().numpy()
        near = np.abs(np.arange(K) - q) <= 2
        true_s = float(s[near].max())
        imp_s = float(s[~near].max())
        seps.append(true_s - imp_s)
        best_imp.append(imp_s)
        top1 += int(true_s > imp_s)
    seps = np.asarray(seps)
    return {
        "K": K, "W": W,
        "top1_acc": round(top1 / len(qs), 3),
        "sep_mean": round(float(seps.mean()), 4),
        "sep_min": round(float(seps.min()), 4),
        "impostor_mean": round(float(np.mean(best_imp)), 4),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--Ks", type=int, nargs="*",
                    default=[64, 256, 1024])
    ap.add_argument("--Ws", type=int, nargs="*",
                    default=[1024, 4096, 16384])
    ap.add_argument("--out", default="artifacts/torch_vocab_scale")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def run(args):
    rows = []
    for K in args.Ks:
        for W in args.Ws:
            r = run_one(K, W, device=args.device)
            rows.append(r)
            print(json.dumps(r), flush=True)
    results = {"flip": 0.08, "F": 128, "stride": 64, "rows": rows}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", os.path.join(args.out, "results.json"))
    return results


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
