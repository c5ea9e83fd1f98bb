"""Fleet tracking: B robots' tracking on one GPU as one batched program
(port of se2lam_tpu/parallel/fleet.py).

Every stage is a function of fixed-shape tensors, so a fleet is a leading
robot axis: the batch extractor takes the B frames of a step at once
(``OrbExtractor.forward_batch``: ⌈5B/8⌉ FAST+NMS launches at 5 levels),
and ``torch.func.vmap`` runs ``tracking.track_frame`` for all robots,
each with its own drawn RANSAC noise. The launches of a step do not grow
with B, except K1's. Robots share nothing.

On a device mesh (``mesh=``, ``parallel.make_mesh``) the robot axis is cut
into n contiguous chunks, one per block (``shard_fleet``; n must divide
B): each block extracts and steps only its own robots, on its own device,
and values cross as a ``ShardedFleet`` (one batched tree per block;
``gather`` puts them back in robot order). Pure data parallelism: no
collective, and robot b's results are its ``mesh=None`` ones.
"""
from __future__ import annotations

import torch

from .. import tracking
from ..config import SystemConfig
from ..device import resolve_device
from ..frontend.orb import OrbConfig, OrbExtractor

__all__ = ["make_fleet_tracker", "shard_fleet"]


def tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped (named) tuples."""
    t = trees[0]
    if isinstance(t, tuple):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
    return fn(*trees)


class ShardedFleet:
    """A batched tree with its robot axis over a mesh: ``blocks[i]`` holds
    this process's block i, consecutive robots, on its device."""

    def __init__(self, blocks, mesh):
        self.blocks = list(blocks)
        self.mesh = mesh

    def gather(self, device=None):
        """This process's robots' tree in robot order, on ``device`` (the
        mesh's first by default)."""
        dev = device or self.mesh.devices[0]
        return tree_map(lambda *xs: torch.cat([x.to(dev) for x in xs]), *self.blocks)


def shard_fleet(tree, mesh, axis: str = "d") -> ShardedFleet:
    """A batched tree (or tensor) with its robot axis cut into the mesh's
    blocks, each on its device. The mesh's size must divide the fleet's."""
    if isinstance(tree, ShardedFleet):
        return tree
    split = tree_map(lambda x: mesh.split(torch.as_tensor(x)), tree)
    blocks = [tree_map(lambda parts, i=i: parts[i], split) for i in range(len(mesh.devices))]
    return ShardedFleet(blocks, mesh)


def per_block(mesh, make):
    """``make(device)`` for each of the mesh's local blocks, built once per
    distinct device."""
    built = {}
    for d in mesh.devices:
        if str(d) not in built:
            built[str(d)] = make(d)
    return [built[str(d)] for d in mesh.devices]


def run_blocks(mesh, fns, *args):
    """Block i's ``fns[i]`` on block i's share of every argument (each
    cut by ``shard_fleet``); the outputs as ShardedFleets."""
    shards = [shard_fleet(a, mesh).blocks for a in args]
    outs = [fn(*(sh[i] for sh in shards)) for i, fn in enumerate(fns)]
    if isinstance(outs[0], tuple) and not hasattr(outs[0], "_fields"):
        return tuple(ShardedFleet([o[j] for o in outs], mesh) for j in range(len(outs[0])))
    return ShardedFleet(outs, mesh)


def _tracker(cfg: SystemConfig, orb_cfg: OrbConfig, dev):
    """The fleet tracker's three functions on one device."""
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

    ``device=None`` means CUDA. With ``mesh`` every function takes batched
    trees or ``ShardedFleet``s and returns ``ShardedFleet``s: block i runs
    its own robots on its device (``device`` is then unused)."""
    if orb_cfg is None:
        orb_cfg = OrbConfig(height=cfg.height, width=cfg.width, n_features=cfg.cap.n_features,
                            scale_factor=cfg.scale_factor, n_levels=cfg.max_level)
    if mesh is None:
        return _tracker(cfg, orb_cfg, resolve_device(device))
    fns = per_block(mesh, lambda d: _tracker(cfg, orb_cfg, d))
    return tuple((lambda *a, j=j: run_blocks(mesh, [f[j] for f in fns], *a)) for j in range(3))
