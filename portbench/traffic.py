"""The one traffic generator: it reads a mix's parameters
(``portbench/traffic/<name>.json``) and makes, from the seed, the frames
and odometry of a run. Frames are rendered once, one lap, and replayed;
odometry is drawn fresh for every step.

Parameters of a mix:

- ``lap_frames``, ``radius``: the route, a circle about the room's centre
  cut into this many frames; ``phase``: where the window's lap starts, in
  frames' arcs;
- ``odo_noise``: the per-step std of (x, y, θ) odometry error;
- ``jump_every``, ``jump_frames``: every ``jump_every``-th frame the true
  pose also moves ``jump_frames`` frames along the route, unseen by the
  odometry (0: never); ``restart``: the robot is restarted where it
  stands before each such frame, a fresh system built through the
  public constructor, which carries nothing over;
- ``map_laps``, ``map_odo_noise``: laps of the route at phase 0 that
  set-up maps before the window (0: no map);
- ``max_frames_per_s``: the window's frames are made for this rate over
  the run's seconds, so a faster program never runs out;
- ``warm_frames``: the frames set-up runs once on a throwaway system.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .world import circle, odometry, se2_minus

__all__ = ["Traffic", "load_traffic", "make_sequence"]


@dataclass
class Traffic:
    lap_frames: int
    radius: float
    odo_noise: tuple
    max_frames_per_s: float
    phase: float = 0.0
    jump_every: int = 0
    jump_frames: int = 0
    restart: bool = False
    map_laps: int = 0
    map_odo_noise: tuple = (0.0, 0.0, 0.0)
    warm_frames: int = 12


def load_traffic(path: Path) -> Traffic:
    doc = json.loads(Path(path).read_text())
    return Traffic(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in doc.items()})


@dataclass
class Sequence:
    """A run's inputs: ``lap`` the rendered poses (L, 3); for the window,
    ``img_idx`` (n,) into the lap, ``jumps`` (n,) the frames that jumped,
    ``gt`` (n, 3) and ``odo`` (n, 3); the mapping laps (``map_gt``,
    ``map_odo``; empty without a map)."""
    lap: np.ndarray
    img_idx: np.ndarray
    jumps: np.ndarray
    gt: np.ndarray
    odo: np.ndarray
    map_gt: np.ndarray
    map_odo: np.ndarray


def make_sequence(tr: Traffic, seconds: float, rng: np.random.Generator) -> Sequence:
    L = tr.lap_frames
    lap = circle(L, tr.radius, tr.phase)
    n = max(int(math.ceil(tr.max_frames_per_s * seconds)), tr.warm_frames + 1)
    t = np.arange(n)
    jumps = (t > 0) & (t % tr.jump_every == 0) if tr.jump_every else np.zeros(n, bool)
    q = np.cumsum(np.where(t > 0, 1 + tr.jump_frames * jumps, 0))
    img_idx = q % L
    # the odometry sees one frame's step, never the jump
    step = se2_minus(lap[1], lap[0])
    odo = odometry(np.repeat(step[None], n - 1, 0), lap[0], np.asarray(tr.odo_noise), rng)
    map_gt = np.tile(circle(L, tr.radius, 0.0), (tr.map_laps, 1))
    map_odo = (odometry(np.repeat(se2_minus(map_gt[1], map_gt[0])[None], len(map_gt) - 1, 0),
                        map_gt[0], np.asarray(tr.map_odo_noise), rng)
               if tr.map_laps else np.zeros((0, 3), np.float32))
    return Sequence(lap=lap, img_idx=img_idx, jumps=jumps, gt=lap[img_idx], odo=odo,
                    map_gt=map_gt, map_odo=map_odo)
