"""The port's keyframe-bank-split loop scoring (``parallel/dist_loop.py``)
against its unsplit scoring and the JAX package's sharded scoring, on the
conftest's 8 CPU devices and n blocks of the CPU.

The bank's tail rows are padding (zero rows, masked out), as a bank
padded to a multiple of the mesh is. Tolerance: against the port's unsplit
scoring, bitwise, index and score (every row's score is the same sum
whichever block holds it; the best row is the lowest among ties, as
``jnp.argmax``/``argmin`` pick). Against JAX: the index equal, the BoW
score within 1e-6 (``vocab.bow_score`` sums a row's 256 terms in another
order than XLA, ``tests/test_torch_vocab.py``), the Hamming distance
(an integer) equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from se2lam_tpu.parallel import make_mesh as jmesh
from se2lam_tpu.parallel import shard_bank as jshard
from se2lam_tpu.parallel import sharded_bow_detect as jbow
from se2lam_tpu.parallel import sharded_hamming_detect as jham
from se2lam_tpu_torch.convert import sharded_bank_from_numpy
from se2lam_tpu_torch.loopclose import bow_detect
from se2lam_tpu_torch.parallel import (
    make_mesh, shard_bank, sharded_bow_detect, sharded_hamming_detect,
)
from se2lam_tpu_torch.parallel.dist_loop import ShardedRows

torch.set_num_threads(2)

K, W, PAD = 64, 256, 8


def _bow_bank(rng):
    bank = np.abs(rng.normal(0, 1, (K, W))).astype(np.float32)
    bank *= rng.random((K, W)) < 0.3                # sparse, as BoW vectors are
    bank /= np.maximum(bank.sum(1, keepdims=True), 1e-12)
    bank[K - PAD:] = 0.0                             # padding rows
    return bank


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("case", ["self", "other", "tie"])
def test_sharded_bow_detect_bitwise(n, case):
    rng = np.random.default_rng(n)
    bank = _bow_bank(rng)
    if case == "tie":
        bank[40] = bank[9]                           # the lower row must win
    query = bank[9] if case != "other" else _bow_bank(rng)[3]
    eligible = np.arange(K) < K - PAD
    if case == "self":
        eligible[9] = False                          # the query's own row is masked
    t = torch.from_numpy
    got_i, got_s = sharded_bow_detect(shard_bank(t(bank), make_mesh(n, device="cpu")),
                                      t(query), t(eligible))
    want_i, want_s = bow_detect(t(bank), t(query), t(eligible))
    j_i, j_s = jbow(jshard(jnp.asarray(bank), jmesh(n)), jnp.asarray(query),
                    jnp.asarray(eligible))
    assert int(got_i) == int(want_i) == int(j_i)
    assert float(got_s) == float(want_s)
    assert abs(float(got_s) - float(j_s)) <= 1e-6
    if case == "tie":
        assert int(got_i) == 9


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("hit", [True, False])
def test_sharded_hamming_detect_bitwise(n, hit):
    rng = np.random.default_rng(10 + n)
    bank = (1 - 2 * rng.integers(0, 2, (K, 256))).astype(np.int8)
    bank[K - PAD:] = 0                               # padding rows: 128 from any query
    valid = np.arange(K) < K - PAD
    q = bank[K // 2].copy() if hit else (1 - 2 * rng.integers(0, 2, 256)).astype(np.int8)
    if hit:
        q[:5] *= -1                                  # 5 bits off row K/2
    t = torch.from_numpy
    got_i, got_d = sharded_hamming_detect(sharded_bank_from_numpy(bank, make_mesh(n, "d", "cpu")),
                                          t(q[None]), t(valid))
    jbank = jax.device_put(jnp.asarray(bank), NamedSharding(jmesh(n), P("d", None)))
    j_i, j_d = jham(jbank, jnp.asarray(q[None]), jnp.asarray(valid))
    assert int(got_i) == int(j_i) and float(got_d) == float(j_d)
    assert valid[int(got_i)]
    if hit:
        assert int(got_i) == K // 2 and float(got_d) == 5.0
    # unsplit, and unmasked: a miss lands on a padding row at 128
    u_i, u_d = sharded_hamming_detect(t(bank), t(q[None]), t(valid))
    assert (int(u_i), float(u_d)) == (int(got_i), float(got_d))
    if not hit:
        m_i, m_d = sharded_hamming_detect(t(bank), t(q[None]))
        assert float(m_d) <= 128.0


def test_sharded_rows_put_row_and_gather():
    bank = torch.arange(K * 4, dtype=torch.float32).reshape(K, 4)
    sb = shard_bank(bank, make_mesh(8, device="cpu"))
    assert isinstance(sb, ShardedRows) and len(sb.blocks) == 8 and sb.shape == (K, 4)
    sb2 = sb.put_row(13, torch.full((4,), -1.0))
    want = bank.clone()
    want[13] = -1.0
    assert torch.equal(sb2.gather(), want) and torch.equal(sb.gather(), bank)
    with pytest.raises(ValueError, match="do not divide"):
        shard_bank(bank[:K - 3], make_mesh(8, device="cpu"))
