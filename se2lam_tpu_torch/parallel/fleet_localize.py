"""Fleet localization: B robots localizing against ONE map on one GPU
(port of se2lam_tpu/parallel/fleet_localize.py).

The serving shape of the localization-only mode: a site's map is built
once (``SlamSystem.save_map``) and a fleet localizes on it. A step is the
chunked localizer (``localizer._localize_chunk``: the tracked step over k
frames, the accept gates on the device) under ``torch.func.vmap`` over the
robots, the map shared and never copied per robot. Each chunk step's
projection match is ONE launch of the windowed top-2 kernel for the whole
fleet (its vmap rule, ``frontend.windowed_match``), so a chunk makes k
launches whatever B. A robot's carry freezes at its first lost frame;
the host relocalizes it out of band (a ``Localizer``) and feeds it back.

On a device mesh (``mesh=``) the robots are cut into the mesh's blocks
(``fleet.shard_fleet``): each block steps its own robots on its device,
against one copy of the map a device, and the values cross as
``ShardedFleet``s.
"""
from __future__ import annotations

import torch

from ..config import SystemConfig
from ..device import resolve_device
from ..frontend.orb import OrbConfig, make_batch_extractor
from ..localizer import _localize_chunk
from ..mapstate import MapState
from ..ops.camera import CameraModel
from .fleet import per_block, run_blocks

__all__ = ["make_fleet_localizer"]


def _localizer(cfg: SystemConfig, ms: MapState, min_tracked_matches: int, dev):
    """The fleet localizer's two functions on one device."""
    ms = MapState(*(t.to(dev) for t in ms))
    orb_cfg = OrbConfig(height=cfg.height, width=cfg.width, n_features=cfg.cap.n_features,
                        scale_factor=cfg.scale_factor, n_levels=cfg.max_level)
    cam = CameraModel.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist, device=dev)
    undistort = any(abs(d) > 0 for d in cfg.dist)
    batch_extract = make_batch_extractor(orb_cfg, cam, undistort, device=dev)

    def extract_fn(img_stack):
        img_stack = torch.as_tensor(img_stack).to(dev)
        B, k = img_stack.shape[:2]
        feats = batch_extract(img_stack.reshape((B * k,) + tuple(img_stack.shape[2:])))
        return type(feats)(*(x.reshape((B, k) + tuple(x.shape[1:])) for x in feats))

    def one_robot(pose, last, feats, odo):
        k = odo.shape[0]
        return _localize_chunk(ms, pose, last, feats, odo, 0, k, min_tracked_matches, cfg)

    step_b = torch.vmap(one_robot)

    def step_fn(pose_b, last_odom_b, feats_bk, odo_bk):
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32).to(dev)
        return step_b(f32(pose_b), f32(last_odom_b), feats_bk, f32(odo_bk))

    return extract_fn, step_fn


def make_fleet_localizer(cfg: SystemConfig, ms: MapState, min_tracked_matches: int = 10,
                         mesh=None, axis: str = "d", device=None):
    """Returns (extract_fn, step_fn):

    - extract_fn(img_stack (B, k, H, W)) → OrbFeatures with (B, k) axes,
      the B·k frames in one batched extraction;
    - step_fn(pose_b (B, 3), last_odom_b (B, 3), feats_bk, odo_bk (B, k, 3))
      → (poses (B, k, 3), tracked (B, k) bool).

    Poses live in the map's gauge; odometry readings are raw, only their
    increments matter. ``device=None`` means CUDA; the map moves there.
    With ``mesh`` both functions take batched values or ``ShardedFleet``s
    and return ``ShardedFleet``s, block i's robots on its device."""
    if mesh is None:
        return _localizer(cfg, ms, min_tracked_matches, resolve_device(device))
    fns = per_block(mesh, lambda d: _localizer(cfg, ms, min_tracked_matches, d))
    return tuple((lambda *a, j=j: run_blocks(mesh, [f[j] for f in fns], *a)) for j in range(2))
