"""The port's chunked, pipelined and fleet localization on a JAX-built map.

The map and the JAX-extracted features are those of
``tests/test_torch_localizer.py``'s fixture (320x240, 60 frames of JAX
SLAM, saved with its vocabulary; a second traversal with noisy odometry).

- ``localizer._localize_chunk`` against the JAX package's on 8 frames of
  one robot, whole and from a later start;
- ``parallel.make_fleet_localizer`` against the JAX package's on B = 3
  robots x k = 5 frames (starts 15, 21, 27), on JAX's features, and
  against each robot alone (``_localize_chunk`` and the per-frame
  tracked path);
- ``Localizer.process_chunk`` and ``process_async`` (depths 0 and 3)
  against ``process`` on rendered frames from a cold start, with and
  without a blackout of two frames mid-stream (the pattern of
  ``tests/test_localizer.py:327``).

Tolerances: tracked flags equal; poses within 1e-3, the JAX package's own
between its feeds (``tests/test_localizer.py``): the pose-only solve sums
in another order across the packages and under ``torch.vmap``. The port's
feeds against its own ``process``: bitwise (the same eager ops on the same
inputs; the batched extraction equals the per-frame one on the CPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import localizer as jloc
from se2lam_tpu.io import load_map as jload
from se2lam_tpu.parallel import make_fleet_localizer as jax_fleet_localizer
from se2lam_tpu_torch import localizer as tloc
from se2lam_tpu_torch.io import load_map as tload
from se2lam_tpu_torch.io.synthetic import SyntheticWorld
from se2lam_tpu_torch.parallel import make_fleet_localizer
from se2lam_tpu_torch.tracking import chunk_frame

from test_torch_localizer import START, _port_feats, fixture, jax_reloc_noise  # noqa: F401

torch.set_num_threads(2)
B, K, OFFS = 3, 5, (15, 21, 27)


def _stack(feats_list):
    return jax.tree.map(lambda *a: jnp.stack(a), *feats_list)


def test_localize_chunk_matches_jax(fixture):
    fx = fixture
    jms, _, _ = jload(fx["path"])
    tms, _, _ = tload(fx["path"], device="cpu")
    frames = range(START + 1, START + 9)
    jf = _stack([fx["feats"][i] for i in frames])
    odo = np.stack([fx["odo"][i] for i in frames])
    pose0, last0 = fx["gt_map"][START].astype(np.float32), fx["odo"][START]
    tf = _port_feats(jf)
    for start in (0, 3):
        jp, jt = jloc._localize_chunk(jms, pose0, last0, jf, jnp.asarray(odo),
                                      jnp.asarray(start, jnp.int32), jnp.asarray(8, jnp.int32),
                                      jnp.asarray(10, jnp.int32), fx["cfg"])
        tp, tt = tloc._localize_chunk(tms, torch.from_numpy(pose0), torch.from_numpy(last0), tf,
                                      torch.from_numpy(odo), start, 8, 10, fx["tcfg"])
        assert tt.tolist() == np.asarray(jt).tolist()
        assert int(tt.sum()) >= 8 - start - 1
        np.testing.assert_allclose(tp[start:].numpy(), np.asarray(jp)[start:], rtol=0, atol=1e-3)


def test_fleet_localizer_matches_jax_and_each_robot(fixture):
    fx = fixture
    jms, _, _ = jload(fx["path"])
    tms, _, _ = tload(fx["path"], device="cpu")
    jf = _stack([_stack([fx["feats"][o + j] for j in range(K)]) for o in OFFS])   # (B, K)
    odo = np.stack([np.stack([fx["odo"][o + j] for j in range(K)]) for o in OFFS])
    pose0 = np.stack([fx["gt_map"][o - 1] for o in OFFS]).astype(np.float32)
    last0 = np.stack([fx["odo"][o - 1] for o in OFFS])

    _, jstep = jax_fleet_localizer(fx["cfg"], jms)
    jp, jt = jstep(jnp.asarray(pose0), jnp.asarray(last0), jf, jnp.asarray(odo))
    _, tstep = make_fleet_localizer(fx["tcfg"], tms, device="cpu")
    tf = _port_feats(jf)
    tp, tt = tstep(pose0, last0, tf, odo)
    assert tp.shape == (B, K, 3) and tt.shape == (B, K)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert int(tt.sum()) >= B * K - 2
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-3)

    for b in range(B):
        fb = type(tf)(*(a[b] for a in tf))
        sp, st = tloc._localize_chunk(tms, torch.from_numpy(pose0[b]), torch.from_numpy(last0[b]),
                                      fb, torch.from_numpy(odo[b]), 0, K, 10, fx["tcfg"])
        assert st.tolist() == tt[b].tolist()
        np.testing.assert_allclose(sp.numpy(), tp[b].numpy(), rtol=0, atol=1e-3)
        with pytest.warns(UserWarning, match="without a vocabulary"):
            loc = tloc.Localizer(fx["tcfg"], tms, None, device="cpu")
        loc.set_pose(pose0[b], last0[b])
        out = [loc.process_features(chunk_frame(fb, j), odo[b, j]) for j in range(K)]
        upto = tt[b].tolist().index(False) if not bool(tt[b].all()) else K
        for j in range(upto):
            np.testing.assert_allclose(out[j], tp[b, j].numpy(), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def rendered(fixture):
    fx = fixture
    world = SyntheticWorld(fx["tcfg"], n_landmarks=600, room=10.0, seed=4)
    gt = world.circle_trajectory(60)
    return [world.render(gt[i]) for i in range(START, START + 20)]


def _trajectory(loc):
    return [(t, None if p is None else tuple(p)) for _, p, t in loc.trajectory]


@pytest.mark.parametrize("blackout", [False, True], ids=["steady", "blackout"])
def test_localizer_feeds_match_process(fixture, rendered, blackout):
    fx = fixture
    tms, tvocab, _ = tload(fx["path"], device="cpu")
    frames = list(rendered)
    if blackout:
        for j in (9, 10):   # no features: the tracked gates fail, tracking is lost
            frames[j] = np.zeros_like(frames[j])
    odos = [fx["odo"][START + j] for j in range(len(frames))]

    def make():
        loc = tloc.Localizer(fx["tcfg"], tms, tvocab, reloc_min_inliers=30, device="cpu")
        loc.reloc_gumbel = jax_reloc_noise(fx["cfg"].cap.ransac_trials, fx["cfg"].cap.n_features)
        return loc

    ref = make()
    ref_out = [ref.process(f, o) for f, o in zip(frames, odos)]
    tracked = [t for _, _, t in ref.trajectory]
    assert sum(tracked) >= 12 and tracked[-1]
    if blackout:
        assert not tracked[9] and not tracked[10]

    chk = make()
    out = []
    for i in range(0, len(frames), 8):
        out.extend(chk.process_chunk(frames[i:i + 8], odos[i:i + 8]))
    assert len(out) == len(ref_out)
    for a, b in zip(out, ref_out):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert _trajectory(chk) == _trajectory(ref)
    assert chk.host_reads < ref.host_reads
    if blackout:
        assert chk.frozen_steps > 0

    for depth in (0, 3):
        pip = make()
        pip.pipeline_depth = depth
        for f, o in zip(frames, odos):
            pip.process_async(f, o)
        pip.flush_async()
        assert _trajectory(pip) == _trajectory(ref)
