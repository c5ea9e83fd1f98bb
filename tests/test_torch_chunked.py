"""The chunked and pipelined feeds of the port's ``SlamSystem``.

On the 320x240, 2-level lap of ``tests/test_chunked.py`` (uint8 frames):

- ``tracking.track_chunk`` and ``state_at_step`` against the JAX
  package's on one chunk whose third frame asks for a keyframe, both
  packages on JAX's features and JAX's ``split_chain`` draws;
- the port's ``process_chunk`` (uneven chunks, with and without the
  next-chunk upload), ``process_async`` (depths 0, 1 and 3) and
  ``process_chunk_async`` against the port's ``process``.

(The port's ``process_chunk`` against the JAX package's is in
``tests/test_torch_chunked_loops.py``.)

Tolerances. Port against port: bitwise (keyframe frames, every pose, the
keyframe poses): the feeds run the same eager ops on the same inputs,
and the batched extraction equals the per-frame one bit for bit on the
CPU (``tests/test_torch_fleet.py``). Port against JAX: ``track_chunk`` as
``tests/test_torch_tracking.py`` holds one step (need_kf equal, poses
within 1e-6, match slots equal but for 2%, never two different
features).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu import tracking as jt
from se2lam_tpu.frontend.orb import make_batch_extractor
from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.system import SlamSystem as JaxSlam
from se2lam_tpu_torch import tracking as tt
from se2lam_tpu_torch.convert import (
    config_from_fields, orb_features_from_numpy, track_state_from_numpy,
)
from se2lam_tpu_torch.system import SlamSystem

from test_chunked import _cfg

torch.set_num_threads(2)
N_FRAMES = 33


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gumbel(key, cfg):
    g = jax.random.gumbel(key, (cfg.cap.ransac_trials, cfg.cap.n_features), jnp.float32)
    return torch.from_numpy(np.array(g))


def jax_track_noise(cfg, seed=0):
    """The JAX SlamSystem's per-tracked-frame draws: its key split once a
    frame (``split_chain`` gives the same sequence)."""
    key = [jax.random.PRNGKey(seed)]

    def nxt():
        key[0], sub = jax.random.split(key[0])
        return _gumbel(sub, cfg)
    return nxt


def port_slam(cfg, **kw):
    return SlamSystem(config_from_fields(dataclasses.asdict(cfg)), enable_loops=False,
                      device="cpu", generator=torch.Generator().manual_seed(0), **kw)


@pytest.fixture(scope="module")
def lap():
    cfg = _cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    frames = [(np.asarray(img).astype(np.uint8), odo)
              for img, odo in world.sequence(N_FRAMES, noise=(0.004, 0.002, 0.002))]
    ref = port_slam(cfg)
    for img, odo in frames:
        ref.process(img, odo)
    return cfg, frames, ref


def _poses(s):
    return np.asarray([p for _, p in s.trajectory], np.float32)


def _assert_same_as(s, ref, returned=None):
    assert s.frame_id == ref.frame_id
    assert s.kf_frame_ids == ref.kf_frame_ids and len(ref.kf_frame_ids) >= 5
    np.testing.assert_array_equal(_poses(s), _poses(ref))
    assert torch.equal(s.ms.kf_pose, ref.ms.kf_pose)
    np.testing.assert_array_equal(s.corrected_trajectory(), ref.corrected_trajectory())
    if returned is not None:
        # every fed frame's pose comes back once, in feed order
        np.testing.assert_array_equal(np.asarray(returned, np.float32).reshape(-1, 3),
                                      _poses(ref))


def test_track_chunk_and_state_at_step_match_jax(lap):
    """Frames 4-11 after the keyframe at frame 3: the keyframe fires at
    frame 6, mid-chunk."""
    cfg, frames, _ = lap
    tcfg = config_from_fields(dataclasses.asdict(cfg))
    js = JaxSlam(cfg, enable_loops=False)
    for img, odo in frames[:4]:
        js.process(img, odo)
    assert js.kf_frame_ids[-1] == 3
    k = 8
    chunk = frames[4:4 + k]
    oc = js.orb_cfg
    feats = make_batch_extractor(oc)(jnp.asarray(np.stack([f[0] for f in chunk])))
    odo = np.stack([f[1] for f in chunk]).astype(np.float32)
    _, keys = jt.split_chain(js.key, k)
    ts_f, needs, poses, steps = jt.track_chunk(
        js.ts, feats, jnp.asarray(odo), keys, jnp.asarray(0, jnp.int32),
        jnp.asarray(k, jnp.int32), cfg)

    tts = track_state_from_numpy(_np(js.ts), "cpu")
    tfeats = orb_features_from_numpy(_np(feats), "cpu")
    noise = torch.stack([_gumbel(kk, cfg) for kk in keys])
    tts_f, tneeds, tposes, tsteps = tt.track_chunk(
        tts, tfeats, torch.from_numpy(odo), noise, 0, k, tcfg)
    assert tneeds.tolist() == np.asarray(needs).tolist()
    fire = int(np.argmax(np.asarray(needs)))
    assert np.asarray(needs)[fire] and 0 < fire < k - 1
    np.testing.assert_allclose(tposes.numpy(), np.asarray(poses), rtol=0, atol=1e-6)

    want = jt.state_at_step(js.ts, jax.tree.map(lambda a: a[fire], feats), steps, fire)
    got = tt.state_at_step(tts, tt.chunk_frame(tfeats, fire), tsteps, fire)
    w, g = np.asarray(want.match_idx), got.match_idx.numpy()
    differ = w != g
    assert differ.sum() <= 0.02 * w.size and not (differ & (w >= 0) & (g >= 0)).any()
    assert int(got.frames_since_kf) == int(want.frames_since_kf) == fire + 1
    np.testing.assert_allclose(got.cur_pose.numpy(), np.asarray(want.cur_pose), atol=1e-6)
    np.testing.assert_allclose(got.pre_meas.numpy(), np.asarray(want.pre_meas), atol=1e-6)
    np.testing.assert_allclose(got.pre_cov.numpy(), np.asarray(want.pre_cov),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(got.cur_feats.desc_bits.numpy().view(np.uint32),
                                  np.asarray(want.cur_feats.desc_bits))
    # the state after the last step is the final state of the chunk
    last = tt.state_at_step(tts, tt.chunk_frame(tfeats, k - 1), tsteps, k - 1)
    for a, b in zip(last, tts_f):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
    # steps outside [start, stop) are not run
    _, n2, p2, s2 = tt.track_chunk(tts, tfeats, torch.from_numpy(odo), noise, 2, 5, tcfg)
    assert s2[0] is None and s2[1] is None and s2[5] is None and s2[2] is not None
    assert not n2[:2].any() and not n2[5:].any() and not p2[5:].any()


@pytest.mark.parametrize("next_imgs", [False, True], ids=["plain", "prefetch"])
def test_process_chunk_matches_process(lap, next_imgs):
    cfg, frames, ref = lap
    s = port_slam(cfg)
    imgs, odos = [f[0] for f in frames], [f[1] for f in frames]
    i, sizes = 0, (1, 7, 8, 8, 9)   # uneven chunks, the bootstrap frame alone
    for n, size in enumerate(sizes):
        nxt = None
        if next_imgs and n + 1 < len(sizes):
            nxt = imgs[i + size:i + size + sizes[n + 1]]
        out = s.process_chunk(imgs[i:i + size], odos[i:i + size], next_imgs=nxt)
        assert out.shape == (size, 3)
        i += size
    _assert_same_as(s, ref)
    # one decision read per segment instead of one a frame
    assert s.host_reads < ref.host_reads
    if next_imgs:
        # the prefetch is one-shot and keyed on the image objects
        s.prefetch_chunk(imgs[:6])
        assert s._take_prefetched(imgs[6:12]) is None
        assert s._take_prefetched(imgs[:6]) is None
        s.prefetch_chunk(imgs[:6])
        assert s._take_prefetched(imgs[:6]) is not None


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_process_async_matches_process(lap, depth):
    cfg, frames, ref = lap
    s = port_slam(cfg)
    s.pipeline_depth = depth
    returned = []
    for img, odo in frames:
        p = s.process_async(img, odo)
        if p is not None:
            returned.append(p)
    returned.extend(s.flush_async())
    _assert_same_as(s, ref, returned)
    assert s.host_reads == ref.host_reads


def test_process_chunk_async_matches_process(lap):
    cfg, frames, ref = lap
    s = port_slam(cfg)
    out = []
    for i in range(0, N_FRAMES, 8):
        r = s.process_chunk_async([f[0] for f in frames[i:i + 8]],
                                  [f[1] for f in frames[i:i + 8]])
        if r is not None:
            out.append(r)
    out.append(s.flush_chunk_async())
    _assert_same_as(s, ref, np.concatenate(out, 0))
