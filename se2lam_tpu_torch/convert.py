"""Carry state from the JAX package into the port.

The JAX package's values arrive as numpy arrays (``np.asarray`` of each
leaf), its configuration as a dict of fields (``dataclasses.asdict``); these
functions turn them into the port's tensors and dataclasses on a device.
Nothing here imports JAX: any object with the right field names will do.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Capacity, SystemConfig
from .device import resolve_device
from .frontend.orb import OrbFeatures
from .loopclose import LoopCloser
from .mapstate import MapState
from .solver.ba import BAProblem
from .solver.posegraph import PoseGraphProblem
from .tracking import TrackState
from .vocab import Vocabulary

__all__ = [
    "orb_features_from_numpy", "track_state_from_numpy", "config_from_fields",
    "map_state_from_numpy", "ba_problem_from_numpy", "vocabulary_from_numpy",
    "pose_graph_from_numpy", "loop_closer_from_numpy",
]


def _tensor(a, dev):
    a = np.array(a, copy=True, order="C")   # tensors may be written in place
    if a.dtype == np.uint32:
        # uint32 tensors have few ops in torch; the bits go across as such
        return torch.from_numpy(a.view(np.int32)).to(dev).view(torch.uint32)
    return torch.from_numpy(a).to(dev)


def orb_features_from_numpy(feats, device=None) -> OrbFeatures:
    """OrbFeatures from an object with the same fields holding numpy
    arrays (or anything ``np.asarray`` takes); dtypes and shapes are kept,
    so leading axes (a chunk's frames, a fleet's robots) carry across."""
    dev = resolve_device(device)
    return OrbFeatures(*(_tensor(getattr(feats, k), dev) for k in OrbFeatures._fields))


def track_state_from_numpy(ts, device=None) -> TrackState:
    """TrackState from an object with the same fields, converting the two
    nested OrbFeatures (``ref_feats``, ``cur_feats``) as well; a fleet's
    batched state (a leading robot axis on every field) carries across as
    it is."""
    dev = resolve_device(device)
    fields = {}
    for k in TrackState._fields:
        v = getattr(ts, k)
        if k in ("ref_feats", "cur_feats"):
            fields[k] = orb_features_from_numpy(v, dev)
        else:
            fields[k] = _tensor(v, dev)
    return TrackState(**fields)


def config_from_fields(fields: dict) -> SystemConfig:
    """SystemConfig from a dict of its fields (``dataclasses.asdict`` of the
    JAX package's); ``cap`` may be a dict of Capacity fields."""
    kw = dict(fields)
    if isinstance(kw.get("cap"), dict):
        kw["cap"] = Capacity(**kw["cap"])
    return SystemConfig(**kw)


def map_state_from_numpy(ms, device=None) -> MapState:
    """MapState from an object with the same fields (the JAX package's
    MapState as numpy arrays); names, shapes and dtypes carry over."""
    dev = resolve_device(device)
    return MapState(*(_tensor(getattr(ms, k), dev) for k in MapState._fields))


def ba_problem_from_numpy(prob, device=None) -> BAProblem:
    """BAProblem from an object with the same fields."""
    dev = resolve_device(device)
    return BAProblem(*(_tensor(getattr(prob, k), dev) for k in BAProblem._fields))


def vocabulary_from_numpy(vocab, device=None) -> Vocabulary:
    """Vocabulary from an object with ``words`` and ``idf``."""
    dev = resolve_device(device)
    return Vocabulary(*(_tensor(getattr(vocab, k), dev) for k in Vocabulary._fields))


def pose_graph_from_numpy(prob, device=None) -> PoseGraphProblem:
    """PoseGraphProblem from an object with the same fields."""
    dev = resolve_device(device)
    return PoseGraphProblem(*(_tensor(getattr(prob, k), dev) for k in PoseGraphProblem._fields))


def loop_closer_from_numpy(cfg: SystemConfig, *, vocab, bank, last_loop=None, cooldown=False,
                           n_inserts: int = 0, trained_at_nkf: int = 0, global_ba_iters=None,
                           device=None) -> LoopCloser:
    """A LoopCloser in the state of the JAX package's: its vocabulary
    (``words``, ``idf``), BoW bank (K, W), last closure (cand, k) or None,
    GlobalBA cooldown, and the retrain schedule (insertions counted, and
    the count at the last training)."""
    dev = resolve_device(device)
    lc = LoopCloser(cfg, global_ba_iters=global_ba_iters, device=dev)
    lc.vocab = vocabulary_from_numpy(vocab, dev)
    lc.bank = _tensor(bank, dev)
    lc.last_loop = None if last_loop is None else tuple(int(x) for x in last_loop)
    lc._gba_cooldown = bool(cooldown)
    lc._n_inserts, lc._trained_at_nkf = int(n_inserts), int(trained_at_nkf)
    return lc
