"""The port's ``SlamSystem`` through a camera blackout against the JAX
package's, as ``tests/test_vision_loss.py`` runs it: frames 12-17 of the
36-frame 160x120 lap of ``SyntheticWorld(n_landmarks=300, room=10.0,
seed=5)`` are blank, or noise from ``default_rng(9)``. Both packages see
the same frames and the port replays the JAX package's per-frame RANSAC
draws (``jax_draws.run_jax_slam``).

Tolerances: every pose finite; a keyframe after the blackout; the same
keyframe frame ids; each package's live and corrected ATE under the JAX
test's 0.3 m, and the two packages' within 0.02 m of each other
(``tests/test_torch_system.py``'s rule).
"""
import dataclasses

import numpy as np
import pytest
import torch

from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io.trajectory import ate_se2
from se2lam_tpu_torch.system import SlamSystem

from jax_draws import run_jax_slam
from test_vision_loss import BLACKOUT, _cfg

torch.set_num_threads(2)
N_FRAMES = 36


@pytest.mark.parametrize("flavor", ["blank", "noise"])
def test_vision_blackout_matches_jax(flavor):
    cfg = _cfg()
    world = SyntheticWorld(cfg, n_landmarks=300, room=10.0, seed=5)
    rng = np.random.default_rng(9)
    seq = []
    for i, (img, odo) in enumerate(world.sequence(N_FRAMES, noise=(0.002, 0.001, 0.001))):
        if i in BLACKOUT:
            img = (np.zeros_like(img) if flavor == "blank"
                   else rng.integers(0, 255, img.shape).astype(img.dtype))
        seq.append((img, odo))
    gt = np.asarray(world.gt[:N_FRAMES])
    js = JaxSlam(cfg, enable_loops=False)
    noise = run_jax_slam(js, seq)
    ts = SlamSystem(config_from_fields(dataclasses.asdict(cfg)), enable_loops=False,
                    device="cpu")
    for i, ((img, odo), g) in enumerate(zip(seq, noise)):
        assert np.isfinite(ts.process(img, odo, gumbel=g)).all(), f"frame {i}"
    assert max(ts.kf_frame_ids) > BLACKOUT.stop, ts.kf_frame_ids
    assert ts.kf_frame_ids == js.kf_frame_ids
    ate = {}
    for name, s in (("jax", js), ("port", ts)):
        est = np.asarray([p for _, p in s.trajectory])
        corr = s.corrected_trajectory()
        assert np.isfinite(corr).all()
        ate[name] = (ate_se2(est[:, :2], gt[:, :2])[0],
                     ate_se2(corr[:, 1:3], gt[corr[:, 0].astype(int), :2])[0])
        assert max(ate[name]) < 0.3, (name, ate[name])
    assert max(abs(a - b) for a, b in zip(ate["jax"], ate["port"])) < 0.02, ate
