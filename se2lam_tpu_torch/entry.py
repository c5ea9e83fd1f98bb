"""The port's entry point: the per-frame hot path, ORB extraction followed
by the tracking step, at the bench configuration (640×480, 1000 features,
5 levels, scale 1.2), on a synthetic world. The same flow as the JAX
package's ``__graft_entry__.entry``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tracking
from .config import Capacity, SystemConfig
from .device import resolve_device
from .frontend.orb import OrbConfig, OrbExtractor
from .io.synthetic import SyntheticWorld

__all__ = ["default_cfg", "entry"]


def default_cfg(width=640, height=480, n_features=1000, n_levels=5):
    """(SystemConfig, OrbConfig) of the bench: a rover camera looking along
    body +x, focal length 0.8·width, depth gates 0.2–30 m."""
    Tcb = np.array(
        [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
    )
    oc = OrbConfig(
        height=height, width=width, n_features=n_features,
        scale_factor=1.2, n_levels=n_levels,
    )
    cfg = SystemConfig(
        width=width, height=height,
        fx=width * 0.8, fy=width * 0.8, cx=width / 2, cy=height / 2,
        Tbc=tuple(np.linalg.inv(Tcb).ravel()),
        upper_depth=30.0, lower_depth=0.2,
        max_feature_num=n_features, max_level=n_levels,
        cap=Capacity(n_features=oc.n_slots),
    )
    return cfg, oc


def entry(device=None):
    """(step, example_args). ``step(img, ts, odo, generator=None, *,
    gumbel=None)`` extracts ORB features from ``img`` and runs one tracking
    step against ``ts``; it returns (new TrackState, TrackResult).
    ``example_args`` holds frame 1 of the synthetic world, the state seeded
    from frame 0 (no map points yet), its odometry and a seeded generator.
    ``device=None`` means CUDA and raises without a GPU."""
    dev = resolve_device(device)
    cfg, oc = default_cfg()
    extract = OrbExtractor(oc, device=dev)

    world = SyntheticWorld(cfg, n_landmarks=400, seed=0)
    img0 = torch.from_numpy(world.render(np.zeros(3, np.float32))).to(dev)
    feats0 = extract(img0)
    odo0 = torch.zeros(3, dtype=torch.float32, device=dev)
    ts = tracking.init_track_state(
        feats0, odo0, odo0, 0,
        view_mp=torch.zeros((oc.n_slots, 3), dtype=torch.float32, device=dev),
        obs_mask=torch.zeros(oc.n_slots, dtype=torch.bool, device=dev),
    )

    def step(img, ts, odo, generator=None, *, gumbel=None):
        feats = extract(img)
        return tracking.track_frame(
            ts, feats, odo, cfg, generator=generator, gumbel=gumbel
        )

    odo1 = np.asarray([0.05, 0.0, 0.01], np.float32)
    example_args = (
        torch.from_numpy(world.render(odo1)).to(dev),
        ts,
        torch.from_numpy(odo1).to(dev),
        torch.Generator(device=dev).manual_seed(0),
    )
    return step, example_args
