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
from .tracking import TrackState

__all__ = ["orb_features_from_numpy", "track_state_from_numpy", "config_from_fields"]


def _tensor(a, dev):
    a = np.array(a, copy=True, order="C")   # tensors may be written in place
    if a.dtype == np.uint32:
        # uint32 tensors have few ops in torch; the bits go across as such
        return torch.from_numpy(a.view(np.int32)).to(dev).view(torch.uint32)
    return torch.from_numpy(a).to(dev)


def orb_features_from_numpy(feats, device=None) -> OrbFeatures:
    """OrbFeatures from an object with the same fields holding numpy
    arrays (or anything ``np.asarray`` takes); dtypes are kept."""
    dev = resolve_device(device)
    return OrbFeatures(*(_tensor(getattr(feats, k), dev) for k in OrbFeatures._fields))


def track_state_from_numpy(ts, device=None) -> TrackState:
    """TrackState from an object with the same fields, converting the two
    nested OrbFeatures (``ref_feats``, ``cur_feats``) as well."""
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
