"""What every system driver shares: the configuration built from its file,
the room and the frames made from the seed, the extractor's outputs kept
for the check, and the comparison of those outputs with the plain
extractor."""
from __future__ import annotations

import numpy as np
import torch

from ..reference.orb import OrbConfig, PlainOrb
from ..traffic import make_sequence
from ..world import Camera, World

__all__ = ["Session", "extraction_diff", "system_config"]


def system_config(doc: dict):
    """The port's SystemConfig from a configuration file's ``system`` and
    ``capacity`` groups."""
    from se2lam_tpu_torch.config import Capacity, SystemConfig

    sc = dict(doc["system"])
    for k in ("Tbc", "dist"):
        sc[k] = tuple(float(x) for x in sc[k])
    return SystemConfig(**sc, cap=Capacity(**doc["capacity"]))


class Session:
    """One run's inputs and system. Subclasses give ``build`` (set-up
    beyond the frames), ``start`` (the window's fresh system), ``process``
    (one frame), ``holds`` (what the check keeps of the window's calls,
among its first ``n_frames`` frames), ``counts`` and ``readings``."""

    # the window's frames whose extraction the check keeps, drawn from the
    # first this many, which every run reaches
    EXTRACT_DRAW_FROM, EXTRACT_SAMPLES = 100, 6

    def __init__(self, doc: dict, traffic, seed: int, seconds: float, device):
        self.doc, self.traffic, self.device = doc, traffic, torch.device(device)
        self.seeds = np.random.SeedSequence(seed).generate_state(8, dtype=np.uint64)
        self.cfg = system_config(doc)
        sc = doc["system"]
        self.cam = Camera(sc["width"], sc["height"], sc["fx"], sc["fy"], sc["cx"], sc["cy"])
        w = doc["world"]
        self.world = World(self.cam, w["n_landmarks"], w["room"], seed=int(self.seeds[0]))
        self.seq = make_sequence(traffic, seconds, self.rng(1))
        self.lap_images = [self.world.render_uint8(p) for p in self.seq.lap]
        self.build()

    def rng(self, salt: int) -> np.random.Generator:
        return np.random.default_rng([int(self.seeds[2]), salt])

    def torch_generator(self, salt: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.rng(salt).integers(2 ** 62)))
        return g

    def extract_draw(self, n_frames: int) -> set:
        """The extractor calls of the window that the check keeps, among
        its first ``n_frames`` at most."""
        n = min(self.EXTRACT_DRAW_FROM, n_frames)
        return set(self.rng(12).choice(n, min(self.EXTRACT_SAMPLES, n), replace=False).tolist())

    def image(self, i: int) -> np.ndarray:
        return self.lap_images[self.seq.img_idx[i]]

    def build(self):
        pass

    def orb_config(self) -> OrbConfig:
        sc = self.doc["system"]
        return OrbConfig(height=sc["height"], width=sc["width"],
                         n_features=sc["max_feature_num"], scale_factor=sc["scale_factor"],
                         n_levels=sc["max_level"])

    def tcb(self) -> np.ndarray:
        """Body-to-camera inverse from the configuration's Tbc."""
        return np.linalg.inv(np.asarray(self.doc["system"]["Tbc"], np.float64).reshape(4, 4))


def extraction_diff(session: Session, extracted, tf32: bool = False) -> float:
    """Share of the keypoint slots, over the window's frames drawn from the
    seed (``Session.extract_draw``), where the program's extractor and the
    plain one differ (validity, position, octave or descriptor).
    ``extracted``: those frames' (frame index, OrbFeatures). ``tf32``: the
    control, the plain extractor in TF32 against itself at full precision."""
    if not extracted:
        return float("inf")
    ref = PlainOrb(session.orb_config(), session.device)
    low = PlainOrb(session.orb_config(), session.device, tf32=True) if tf32 else None
    bad = total = 0
    for i, feats in extracted:
        img = torch.from_numpy(session.image(i))
        want = ref(img)
        if low is not None:
            got = low(img)
            g_valid, g_xy, g_oct, g_bits = got["valid"], got["xy"], got["octave"], got["bits"]
        else:
            g_valid, g_xy, g_oct = feats.valid, feats.xy, feats.octave
            g_bits = ((1 - feats.desc_pm1.to(torch.int16)) // 2).to(torch.uint8)
        diff = g_valid != want["valid"]
        live = g_valid | want["valid"]
        diff |= live & ((g_xy != want["xy"]).any(1) | (g_oct != want["octave"])
                        | (g_bits != want["bits"]).any(1))
        bad += int(diff.sum())
        total += int(live.sum())
    return bad / max(total, 1)
