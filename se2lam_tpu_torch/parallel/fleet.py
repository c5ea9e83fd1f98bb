"""Fleet tracking: B robots' tracking on one GPU as one batched program
(port of se2lam_tpu/parallel/fleet.py).

Every stage is a function of fixed-shape tensors, so a fleet is a leading
robot axis: the batch extractor takes the B frames of a step at once
(``OrbExtractor.forward_batch``: ⌈5B/8⌉ FAST+NMS launches at 5 levels),
and ``torch.func.vmap`` runs ``tracking.track_frame`` for all robots,
each with its own drawn RANSAC noise. The launches of a step do not grow
with B, except K1's. Robots share nothing. A device mesh (``mesh=``,
``shard_fleet``) is not ported yet.
"""
from __future__ import annotations

import torch

from .. import tracking
from ..config import SystemConfig
from ..device import resolve_device
from ..frontend.orb import OrbConfig, OrbExtractor

__all__ = ["make_fleet_tracker", "shard_fleet"]


def _no_mesh():
    return NotImplementedError(
        "se2lam_tpu_torch: a device mesh for fleets is not ported yet "
        "(ROADMAP.md §1, item 20)")


def make_fleet_tracker(cfg: SystemConfig, orb_cfg: OrbConfig | None = None, mesh=None,
                       axis: str = "d", device=None):
    """Returns (init_fn, step_fn, extract_fn), every argument with a
    leading robot axis B:

    - init_fn(feats_b, pose_b (B, 3), odom_b (B, 3)) → batched TrackState
      (reference keyframe slot 0, no map points);
    - step_fn(ts_b, imgs_b (B, H, W), odo_b (B, 3), noise_b (B,
      ransac_trials, N)) → (ts_b, TrackResult_b): extraction and one
      tracking step for every robot, robot b's RANSAC drawn from
      ``noise_b[b]`` (``tracking.draw_track_noise`` per robot);
    - extract_fn(imgs_b) → batched OrbFeatures.

    ``device=None`` means CUDA."""
    if mesh is not None:
        raise _no_mesh()
    dev = resolve_device(device)
    if orb_cfg is None:
        orb_cfg = OrbConfig(height=cfg.height, width=cfg.width, n_features=cfg.cap.n_features,
                            scale_factor=cfg.scale_factor, n_levels=cfg.max_level)
    ext = OrbExtractor(orb_cfg, device=dev)
    N = orb_cfg.n_slots

    def init_fn(feats_b, pose_b, odom_b):
        view_mp = torch.zeros((N, 3), dtype=torch.float32, device=dev)
        obs = torch.zeros(N, dtype=torch.bool, device=dev)
        return torch.vmap(
            lambda f, p, o: tracking.init_track_state(f, p, o, 0, view_mp, obs),
        )(feats_b, torch.as_tensor(pose_b).to(dev), torch.as_tensor(odom_b).to(dev))

    def extract_fn(imgs_b):
        if not torch.is_tensor(imgs_b):
            imgs_b = torch.as_tensor(imgs_b)
        return ext.forward_batch(imgs_b.to(dev))

    track_b = torch.vmap(lambda ts, f, o, g: tracking.track_frame(ts, f, o, cfg, gumbel=g))

    def step_fn(ts_b, imgs_b, odo_b, noise_b):
        feats_b = extract_fn(imgs_b)
        return track_b(ts_b, feats_b, torch.as_tensor(odo_b, dtype=torch.float32).to(dev),
                       torch.as_tensor(noise_b, dtype=torch.float32).to(dev))

    return init_fn, step_fn, extract_fn


def shard_fleet(tree, mesh, axis: str = "d"):
    """Not ported yet: the robot axis over a device mesh."""
    raise _no_mesh()
