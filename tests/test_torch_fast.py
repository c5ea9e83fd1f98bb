"""The port's plain FAST-9/16 + 3x3 NMS against the JAX package's XLA
spelling and its Pallas kernel (interpreter mode), and the dispatch rules
of ``fast_nms``.

Tolerance: none. Both sum the 16 margins one by one in circle order, so
the maps are bitwise equal, for non-integer pixels too. Against the Pallas
kernel they are compared inside the 16-px border (EDGE_THRESHOLD), where
its clamped band halos differ from ``roll`` by design
(pallas_fast.py:16-24); against the XLA spelling, over the whole map.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.frontend.fast import fast_score_pair, nms3x3
from se2lam_tpu.frontend.pallas_fast import BAND, fast_nms_pallas
from se2lam_tpu_torch.frontend import fast_nms as port

torch.set_num_threads(2)

E = 16


def sprinkled_image(rng, H, W):
    """Uniform noise with 30 bright 3x3 blocks, as tests/test_pallas_fast.py
    makes it, so both the corner and the non-corner paths run."""
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    for _ in range(30):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 1: y + 2, x - 1: x + 2] = 250.0
    return img


def port_maps(img):
    return [m.numpy() for m in port.fast_nms(torch.from_numpy(img), 20.0, 7.0)]


@pytest.mark.parametrize("shape", [(240, 320), (200, 266), (120, 128)])
def test_plain_matches_xla_and_pallas(shape):
    H, W = shape
    img = sprinkled_image(np.random.default_rng(0), H, W)
    hi, lo, raw = port_maps(img)

    sh_raw, sl_raw = fast_score_pair(jnp.asarray(img), 20.0, 7.0)
    ref = [np.asarray(nms3x3(sh_raw)), np.asarray(nms3x3(sl_raw)), np.asarray(sl_raw)]
    for got, want in zip((hi, lo, raw), ref):
        np.testing.assert_array_equal(got, want)   # the whole map

    pal = fast_nms_pallas(jnp.asarray(img), 20.0, 7.0, interpret=True)
    inner = np.s_[E: H - E, E: W - E]
    for got, want in zip((hi, lo, raw), pal):
        np.testing.assert_array_equal(got[inner], np.asarray(want)[inner])
    assert (hi > 0).sum() > 10 and (lo > 0).sum() > (hi > 0).sum()


def test_band_seams_match_pallas():
    """Rows at the Pallas kernel's interior band boundaries."""
    rng = np.random.default_rng(0)
    H, W = 4 * BAND, 256
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    _, lo, _ = port_maps(img)
    _, pal_lo, _ = fast_nms_pallas(jnp.asarray(img), 20.0, 7.0, interpret=True)
    for b in (1, 2, 3):
        rows = np.s_[b * BAND - 2: b * BAND + 2, E: W - E]
        np.testing.assert_array_equal(lo[rows], np.asarray(pal_lo)[rows])


def test_cpu_tensor_runs_plain_and_counts_nothing():
    img = sprinkled_image(np.random.default_rng(1), 64, 96)
    before = port.fast_nms.launches
    got = port.fast_nms(torch.from_numpy(img), 20.0, 7.0)
    want = port.fast_nms_plain(torch.from_numpy(img), 20.0, 7.0)
    assert port.fast_nms.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_other_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        port.fast_nms(torch.empty((32, 32), device="meta"), 20.0, 7.0)
