"""The port's BoW vocabulary against the JAX package's, on seeded numpy
descriptors.

Tolerances: word assignment and trained words equal (±1 products are
exact in f32 in both, and both take the first maximum); idf, BowVectors
and scores within 1e-6 (log and the L1 normalisation round in another
order); −inf scores equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import vocab as jv
from se2lam_tpu_torch import vocab as tv
from se2lam_tpu_torch.convert import vocabulary_from_numpy

torch.set_num_threads(2)


def _desc(rng, n, flips_from=None, n_flips=20):
    """±1 int8 descriptors; with ``flips_from``, noisy copies of its rows."""
    if flips_from is None:
        return (1 - 2 * rng.integers(0, 2, (n, 256))).astype(np.int8)
    src = flips_from[rng.integers(0, flips_from.shape[0], n)].copy()
    for row in src:
        row[rng.choice(256, n_flips, replace=False)] *= -1
    return src


def _corpus(rng, D=600, n_centers=24, n_docs=12):
    centers = _desc(rng, n_centers)
    desc = _desc(rng, D, flips_from=centers)
    valid = rng.random(D) > 0.15
    desc[~valid] = 0       # invalid slots hold zeros, as the extractor's
    doc_ids = rng.integers(0, n_docs, D).astype(np.int32)
    return desc, valid, doc_ids


def _jax_seed_idx(valid, n_words):
    """The JAX package's seed draw (``vocab.py:101-108``)."""
    p = jnp.asarray(valid, jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    return np.array(jax.random.choice(jax.random.PRNGKey(0), valid.shape[0],
                                      shape=(n_words,), replace=True, p=p))


def test_assign_equal(rng):
    desc, _, _ = _corpus(rng)
    words = _desc(rng, 64)
    words[:8] = words[8:16]    # duplicate words: the first index must win
    want = np.asarray(jv._assign(jnp.asarray(desc), jnp.asarray(words)))
    got = tv._assign(torch.from_numpy(desc), torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("docs", [True, False], ids=["doc_ids", "per_descriptor"])
def test_train_vocab_with_jax_seeds(rng, docs):
    desc, valid, doc_ids = _corpus(rng)
    n_words = 32
    kw_j, kw_t = {}, {}
    if docs:
        kw_j = dict(doc_ids=jnp.asarray(doc_ids), n_docs_cap=16)
        kw_t = dict(doc_ids=torch.from_numpy(doc_ids), n_docs_cap=16)
    jvoc = jv.train_vocab(jnp.asarray(desc), jnp.asarray(valid), n_words=n_words, iters=5,
                          **kw_j)
    tvoc = tv.train_vocab(torch.from_numpy(desc), torch.from_numpy(valid), n_words=n_words,
                          iters=5, seed_idx=_jax_seed_idx(valid, n_words), **kw_t)
    np.testing.assert_array_equal(tvoc.words.numpy(), np.asarray(jvoc.words))
    np.testing.assert_allclose(tvoc.idf.numpy(), np.asarray(jvoc.idf), rtol=0, atol=1e-6)
    assert float(tvoc.idf.max()) > 0


def test_train_vocab_with_generator_draws_valid_seeds(rng):
    desc, valid, _ = _corpus(rng)
    voc = tv.train_vocab(torch.from_numpy(desc), torch.from_numpy(valid), n_words=16,
                         iters=0, generator=torch.Generator().manual_seed(3))
    seeds = {row.tobytes() for row in desc[valid]}
    assert all(w.tobytes() in seeds for w in voc.words.numpy())


def _vocab_pair(rng):
    desc, valid, doc_ids = _corpus(rng)
    jvoc = jv.train_vocab(jnp.asarray(desc), jnp.asarray(valid), n_words=32, iters=4,
                          doc_ids=jnp.asarray(doc_ids), n_docs_cap=16)
    return jvoc, vocabulary_from_numpy(jax.tree.map(np.asarray, jvoc), device="cpu"), desc


def test_bow_transform(rng):
    jvoc, tvoc, corpus = _vocab_pair(rng)
    q = _desc(rng, 200, flips_from=corpus)
    qv = rng.random(200) > 0.2
    jvec, jwords = jv.bow_transform(jvoc, jnp.asarray(q), jnp.asarray(qv))
    tvec, twords = tv.bow_transform(tvoc, torch.from_numpy(q), torch.from_numpy(qv))
    np.testing.assert_array_equal(twords.numpy(), np.asarray(jwords))
    np.testing.assert_allclose(tvec.numpy(), np.asarray(jvec), rtol=0, atol=1e-6)
    # a keyframe bank: the leading axis is the JAX package's vmap
    bank_q = np.stack([q[:100], q[100:]])
    bank_v = np.stack([qv[:100], qv[100:]])
    jbank = jax.vmap(lambda d, m: jv.bow_transform(jvoc, d, m)[0])(
        jnp.asarray(bank_q), jnp.asarray(bank_v))
    tbank, _ = tv.bow_transform(tvoc, torch.from_numpy(bank_q), torch.from_numpy(bank_v))
    np.testing.assert_allclose(tbank.numpy(), np.asarray(jbank), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "zero_rows", "zero_query"])
def test_bow_score(rng, case):
    jvoc, tvoc, corpus = _vocab_pair(rng)
    K, n = 6, 80
    d = np.stack([_desc(rng, n, flips_from=corpus) for _ in range(K)])
    m = rng.random((K, n)) > 0.1
    if case == "zero_rows":
        m[[1, 4]] = False            # empty keyframes: all-zero bank rows
    q = _desc(rng, n, flips_from=corpus)
    qm = np.ones(n, bool) if case != "zero_query" else np.zeros(n, bool)
    jbank = jax.vmap(lambda a, b: jv.bow_transform(jvoc, a, b)[0])(jnp.asarray(d), jnp.asarray(m))
    jq, _ = jv.bow_transform(jvoc, jnp.asarray(q), jnp.asarray(qm))
    want = np.asarray(jv.bow_score(jbank, jq))
    tbank, _ = tv.bow_transform(tvoc, torch.from_numpy(d), torch.from_numpy(m))
    tq, _ = tv.bow_transform(tvoc, torch.from_numpy(q), torch.from_numpy(qm))
    got = tv.bow_score(tbank, tq).numpy()
    inf = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), inf)
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=0, atol=1e-6)
    assert inf.sum() == {"plain": 0, "zero_rows": 2, "zero_query": K}[case]
