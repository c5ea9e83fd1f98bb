"""Map checkpoint and resume (port of se2lam_tpu.io.mapstorage; reference
MapStorage, src/MapStorage.cpp:52-590), in the JAX package's on-disk
format, so a map saved by either package loads in the other:

- ``map.npz`` (compressed): every ``MapState`` field as ``ms_<field>``,
  with the JAX package's names, shapes and dtypes, and, when a vocabulary
  is saved, ``vocab_words`` (W, 256) int8 and ``vocab_idf`` (W,) f32;
- ``meta.json``: ``format_version`` 2, ``n_kf``, ``n_mp``, ``has_vocab``
  and an optional ``meta`` dict.

Version 1 maps have no ``mp_desc_votes``; they load with the votes set to
the stored majority descriptor, a one-observation vote state.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..mapstate import MapState
from ..vocab import Vocabulary

__all__ = ["save_map", "load_map"]

_FORMAT_VERSION = 2  # v2: adds mp_desc_votes (majority-descriptor state)


def save_map(path: str, ms: MapState, vocab: Vocabulary | None = None,
             meta: dict | None = None):
    """Write the map (and optional vocabulary) to the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays = {f"ms_{k}": v.cpu().numpy() for k, v in ms._asdict().items()}
    if vocab is not None:
        arrays["vocab_words"] = vocab.words.cpu().numpy()
        arrays["vocab_idf"] = vocab.idf.cpu().numpy()
    np.savez_compressed(os.path.join(path, "map.npz"), **arrays)
    info = {
        "format_version": _FORMAT_VERSION,
        "n_kf": int(ms.n_kf),
        "n_mp": int(ms.n_mp),
        "has_vocab": vocab is not None,
    }
    if meta:
        info["meta"] = meta
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(info, f, indent=2)


def load_map(path: str, device=None):
    """(MapState, Vocabulary | None, meta dict) from ``path``, on ``device``
    (None means CUDA)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        info = json.load(f)
    version = info.get("format_version")
    if version not in (1, _FORMAT_VERSION):
        raise ValueError(f"unsupported map format: {version}")

    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True, order="C")).to(dev)

    with np.load(os.path.join(path, "map.npz")) as data:
        fields = {name: tensor(data[f"ms_{name}"]) for name in MapState._fields
                  if f"ms_{name}" in data}
        if version == 1 and "mp_desc_votes" not in fields:
            fields["mp_desc_votes"] = fields["mp_desc"].to(torch.int16)
        vocab = None
        if info.get("has_vocab"):
            vocab = Vocabulary(words=tensor(data["vocab_words"]),
                               idf=tensor(data["vocab_idf"]))
    return MapState(**fields), vocab, info
