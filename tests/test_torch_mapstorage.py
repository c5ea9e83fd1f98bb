"""Map storage across the two packages: a map saved by the JAX package
loads in the port, and a map saved by the port loads in the JAX package,
every field and the vocabulary bit for bit (names, shapes, dtypes and
values); a version-1 map (no ``mp_desc_votes``) loads in both with the
same upgrade. The map is a JAX ``empty_map`` filled with seeded random
content of each field's dtype.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from se2lam_tpu.config import Capacity
from se2lam_tpu.io import load_map as jload
from se2lam_tpu.io import save_map as jsave
from se2lam_tpu.mapstate import empty_map as jempty
from se2lam_tpu.vocab import Vocabulary as JVocab
from se2lam_tpu_torch.io import load_map as tload
from se2lam_tpu_torch.io import save_map as tsave
from se2lam_tpu_torch.mapstate import MapState

torch.set_num_threads(2)


def _random_map(seed):
    rng = np.random.default_rng(seed)
    ms = jax.tree.map(np.asarray, jempty(Capacity(max_kfs=6, max_mps=40, n_features=16)))

    def fill(a):
        if a.dtype == np.bool_:
            return rng.random(a.shape) > 0.5
        if a.dtype == np.int8:
            return (1 - 2 * rng.integers(0, 2, a.shape)).astype(np.int8)
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(-1, 30, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)

    ms = ms._replace(**{k: fill(v) for k, v in ms._asdict().items()})
    ms = ms._replace(n_kf=np.asarray(5, np.int32), n_mp=np.asarray(33, np.int32))
    vocab = JVocab(words=(1 - 2 * rng.integers(0, 2, (12, 256))).astype(np.int8),
                   idf=rng.random(12).astype(np.float32))
    return ms, vocab


def _same(port_ms, jax_ms):
    assert port_ms._fields == jax_ms._fields
    for name in MapState._fields:
        a = getattr(port_ms, name)
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(getattr(jax_ms, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def _same_vocab(port_v, jax_v):
    for name in ("words", "idf"):
        a = getattr(port_v, name)
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(getattr(jax_v, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("with_vocab", [True, False], ids=["vocab", "no_vocab"])
def test_jax_saved_map_loads_in_port(tmp_path, with_vocab):
    ms, vocab = _random_map(0)
    jsave(str(tmp_path), ms, vocab if with_vocab else None, meta={"source": "jax"})
    tms, tvocab, info = tload(str(tmp_path), device="cpu")
    _same(tms, ms)
    assert (tvocab is None) != with_vocab
    if with_vocab:
        _same_vocab(tvocab, vocab)
    assert info["n_kf"] == 5 and info["n_mp"] == 33 and info["meta"] == {"source": "jax"}


@pytest.mark.parametrize("with_vocab", [True, False], ids=["vocab", "no_vocab"])
def test_port_saved_map_loads_in_jax(tmp_path, with_vocab):
    ms, vocab = _random_map(1)
    jsave(str(tmp_path / "j"), ms, vocab)
    tms, tvocab, _ = tload(str(tmp_path / "j"), device="cpu")
    tsave(str(tmp_path / "t"), tms, tvocab if with_vocab else None, meta={"source": "port"})
    jms, jvocab, info = jload(str(tmp_path / "t"))
    _same(tms, jms)
    _same(tms, ms)
    assert (jvocab is None) != with_vocab
    if with_vocab:
        _same_vocab(tvocab, jvocab)
    with open(tmp_path / "t" / "meta.json") as f:
        meta = json.load(f)
    assert meta == {"format_version": 2, "n_kf": 5, "n_mp": 33,
                    "has_vocab": with_vocab, "meta": {"source": "port"}}


def test_version_1_map_upgrades_alike(tmp_path):
    ms, vocab = _random_map(2)
    jsave(str(tmp_path), ms, vocab)
    # rewrite it as version 1: no majority-vote state
    with np.load(tmp_path / "map.npz") as data:
        arrays = {k: data[k] for k in data.files if k != "ms_mp_desc_votes"}
    np.savez_compressed(tmp_path / "map.npz", **arrays)
    with open(tmp_path / "meta.json") as f:
        meta = json.load(f)
    meta["format_version"] = 1
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(meta, f)
    jms, _, _ = jload(str(tmp_path))
    tms, _, _ = tload(str(tmp_path), device="cpu")
    _same(tms, jms)
    assert tms.mp_desc_votes.dtype == torch.int16
    assert torch.equal(tms.mp_desc_votes, tms.mp_desc.to(torch.int16))


def test_unknown_version_raises(tmp_path):
    ms, _ = _random_map(3)
    jsave(str(tmp_path), ms)
    with open(tmp_path / "meta.json") as f:
        meta = json.load(f)
    meta["format_version"] = 3
    with open(tmp_path / "meta.json", "w") as f:
        json.dump(meta, f)
    assert os.path.isfile(tmp_path / "map.npz")
    with pytest.raises(ValueError, match="unsupported map format"):
        tload(str(tmp_path), device="cpu")
