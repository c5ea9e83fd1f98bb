"""Flat bag-of-binary-words vocabulary (port of se2lam_tpu.vocab; the
DBoW2 stack of the reference, Thirdparty/DBoW2, without its tree).

- quantization = one (N, 256) × (256, W) ±1 product + argmax; the f32
  product of ±1 values is exact with TF32 off, and ``torch.argmax`` takes
  the first maximum, as ``jnp.argmax`` does
- BowVector    = dense (W,) tf-idf histogram, L1-normalized
- score(a, b)  = DBoW2's L1 similarity 1 − ½·Σ|a−b| (ScoringObject.h:76-98)
  against the whole keyframe bank at once

The vocabulary is trained by binary k-means (bitwise-majority centroids).
Torch cannot reproduce JAX's PRNG, so ``train_vocab`` takes a
``torch.Generator`` for its seed draw or the drawn seed indices
themselves; the parity tests pass JAX's draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "Vocabulary", "train_vocab", "bow_transform", "bow_score", "document_idf",
]


class Vocabulary(NamedTuple):
    words: torch.Tensor   # (W, 256) ±1 int8 word centers
    idf: torch.Tensor     # (W,) f32 inverse-document-frequency weights

    @property
    def n_words(self):
        return self.words.shape[0]


def _assign(desc_pm1, words):
    """Nearest word per descriptor (N,) int64: max ±1 dot = min Hamming.
    ``desc_pm1`` may be int8 or already f32."""
    dot = desc_pm1.to(torch.float32) @ words.to(torch.float32).T
    return torch.argmax(dot, dim=1)


def document_idf(word_ids, valid, doc_ids, n_docs_cap: int, n_words: int):
    """DBoW2 idf: ln(N/Ni) with N the number of documents and Ni those
    containing word i, each document counting a word once; unused words
    weigh 0. A corpus whose used words all appear in every document falls
    back to TF weighting (idf 1 for used words), as the JAX package does."""
    dev = word_ids.device
    ok = valid & (doc_ids >= 0)
    occ = torch.zeros((n_docs_cap + 1, n_words), dtype=torch.bool, device=dev)
    rows = torch.where(ok, doc_ids.long(), torch.full_like(doc_ids.long(), n_docs_cap))
    occ[rows, word_ids.long()] = True
    occ = occ[:n_docs_cap]
    df = occ.sum(dim=0).to(torch.float32)
    n_docs = torch.clamp(occ.any(dim=1).sum().to(torch.float32), min=1.0)
    idf = torch.where(df > 0, torch.log(n_docs / torch.clamp(df, min=1.0)),
                      torch.zeros_like(df))
    return torch.where(idf.max() > 0.0, idf, (df > 0).to(torch.float32))


def train_vocab(
    desc_pm1,            # (D, 256) ±1 int8 training descriptors
    valid,               # (D,) bool
    n_words: int = 1024,
    iters: int = 8,
    *,
    generator: torch.Generator | None = None,
    seed_idx=None,       # (n_words,) drawn seed rows, instead of generator
    doc_ids=None,        # (D,) int32 document (keyframe) per descriptor
    n_docs_cap: int | None = None,
) -> Vocabulary:
    """Binary k-means: Lloyd iterations with bitwise-majority centroids.

    The seeds are ``n_words`` valid rows drawn with replacement, uniformly
    over the valid ones: from ``generator`` (a generator seeded 0 on the
    descriptors' device when neither it nor ``seed_idx`` is given), or
    given as ``seed_idx``. With ``doc_ids`` (and ``n_docs_cap``), idf is
    DBoW2's per-document statistic; without, each descriptor is its own
    document."""
    D = desc_pm1.shape[0]
    dev = desc_pm1.device
    if doc_ids is not None and n_docs_cap is None:
        raise ValueError("train_vocab: doc_ids requires n_docs_cap (an upper "
                         "bound on the number of documents)")
    if seed_idx is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        probs = valid.to(torch.float32)
        if not bool(probs.any()):
            probs = torch.ones_like(probs)
        seed_idx = torch.multinomial(probs, n_words, replacement=True, generator=generator)
    seed_idx = torch.as_tensor(seed_idx, device=dev).long()
    words = desc_pm1[seed_idx]

    desc_f = desc_pm1.to(torch.float32)
    pm1_f = desc_f * valid[:, None]
    valid_f = valid.to(torch.float32)
    for _ in range(iters):
        a = _assign(desc_f, words)
        # per-word sums of ±1 bits (exact integers in f32) → majority sign
        sums = torch.zeros((n_words, 256), dtype=torch.float32, device=dev).index_add_(0, a, pm1_f)
        counts = torch.zeros(n_words, dtype=torch.float32, device=dev).index_add_(0, a, valid_f)
        new = torch.where(sums >= 0, 1, -1).to(torch.int8)
        words = torch.where((counts > 0)[:, None], new, words)   # empty words keep their seed

    a = _assign(desc_f, words)
    if doc_ids is None:
        doc_ids = torch.arange(D, dtype=torch.int32, device=dev)
        n_docs_cap = D
    idf = document_idf(a, valid, torch.as_tensor(doc_ids, device=dev), n_docs_cap, n_words)
    return Vocabulary(words=words, idf=idf)


def bow_transform(vocab: Vocabulary, desc_pm1, valid):
    """(..., N, 256) descriptors, (..., N) valid → the L1-normalized tf-idf
    BowVector (..., W) and the word id per descriptor (..., N) int32, −1
    where invalid. A leading batch axis (a keyframe bank) is the JAX
    package's ``vmap``."""
    W = vocab.n_words
    a = _assign(desc_pm1.reshape(-1, 256), vocab.words).reshape(valid.shape)
    tf = torch.zeros(valid.shape[:-1] + (W,), dtype=torch.float32, device=valid.device)
    tf = tf.scatter_add_(-1, a, valid.to(torch.float32))
    v = tf * vocab.idf
    v = v / torch.clamp(v.abs().sum(dim=-1, keepdim=True), min=1e-12)
    return v, torch.where(valid, a, torch.full_like(a, -1)).to(torch.int32)


def bow_score(bank, v):
    """DBoW2 L1 score of ``v`` (W,) against every row of ``bank`` (K, W).
    An all-zero bank row (an empty, pruned or padded keyframe) and every
    row against an all-zero query score −inf: the raw formula would give
    them 0.5, above real non-matches."""
    s = 1.0 - 0.5 * (bank - v[None, :]).abs().sum(dim=1)
    nz = (bank != 0.0).any(dim=1) & (v != 0.0).any()
    return torch.where(nz, s, torch.full_like(s, float("-inf")))
