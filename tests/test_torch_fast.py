"""The port's plain FAST-9/16 + 3x3 NMS against the JAX package's XLA
spelling and its Pallas kernel (interpreter mode), one level at a time and
as ``fast_nms_levels`` on a frame's pyramid, and the dispatch rules of
``fast_nms`` and ``fast_nms_levels``.

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

from se2lam_tpu.frontend.fast import fast_score, fast_score_pair, nms3x3
from se2lam_tpu.frontend.pallas_fast import BAND, fast_nms_pallas
from se2lam_tpu_torch.entry import default_cfg
from se2lam_tpu_torch.frontend import fast as port_fast
from se2lam_tpu_torch.frontend import fast_nms as port
from se2lam_tpu_torch.frontend.orb import OrbExtractor

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


@pytest.mark.parametrize("shape,threshold", [((240, 320), 20.0), ((120, 128), 7.0),
                                             ((200, 266), 12.5)])
def test_single_threshold_score_matches_xla(shape, threshold):
    """``fast_score`` (one threshold, its own margin) bitwise the JAX
    package's over the whole map."""
    img = sprinkled_image(np.random.default_rng(2), *shape)
    got = port_fast.fast_score(torch.from_numpy(img), threshold).numpy()
    want = np.asarray(fast_score(jnp.asarray(img), threshold))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 10


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


@pytest.fixture(scope="module")
def pyramid_maps():
    """The five pyramid levels of a 320x240 frame (the extractor's own
    pyramid, so levels 1-4 hold non-integer pixels) and their maps from one
    ``fast_nms_levels`` call on the CPU."""
    _, oc = default_cfg(width=320, height=240)
    img = torch.from_numpy(sprinkled_image(np.random.default_rng(3), 240, 320))
    levels = OrbExtractor(oc, device="cpu").pyramid(img)
    assert [tuple(lv.shape) for lv in levels] == oc.level_shapes == [
        (240, 320), (200, 267), (167, 222), (139, 185), (116, 154)]
    before = port.fast_nms.launches
    maps = port.fast_nms_levels(levels, 20.0, 7.0)
    assert port.fast_nms.launches == before          # the CPU path counts no launch
    return levels, maps


@pytest.mark.parametrize("level", range(5))
def test_levels_match_xla_and_pallas(pyramid_maps, level):
    """Each level of one ``fast_nms_levels`` call: bitwise equal to JAX's
    ``fast_score_pair`` + ``nms3x3`` over the whole map, and to the Pallas
    kernel inside the 16-px border."""
    levels, maps = pyramid_maps
    img = levels[level].numpy()
    H, W = img.shape
    hi, lo, raw = (m.numpy() for m in maps[level])
    sh_raw, sl_raw = fast_score_pair(jnp.asarray(img), 20.0, 7.0)
    ref = [np.asarray(nms3x3(sh_raw)), np.asarray(nms3x3(sl_raw)), np.asarray(sl_raw)]
    for got, want in zip((hi, lo, raw), ref):
        np.testing.assert_array_equal(got, want)
    pal = fast_nms_pallas(jnp.asarray(img), 20.0, 7.0, interpret=True)
    inner = np.s_[E: H - E, E: W - E]
    for got, want in zip((hi, lo, raw), pal):
        np.testing.assert_array_equal(got[inner], np.asarray(want)[inner])
    assert (lo > 0).sum() > 0


def test_levels_plain_is_fast_nms_plain_level_by_level(pyramid_maps):
    levels, maps = pyramid_maps
    plain = port.fast_nms_levels_plain(levels, 20.0, 7.0)
    assert len(maps) == len(plain) == len(levels)
    for lv, got, want in zip(levels, maps, plain):
        for g, w, one in zip(got, want, port.fast_nms_plain(lv, 20.0, 7.0)):
            assert g.shape == lv.shape
            assert torch.equal(g, w) and torch.equal(w, one)


@pytest.mark.parametrize("levels", [
    [torch.empty((32, 32), device="meta")],
    [torch.zeros((32, 32)), torch.empty((16, 16), device="meta")],
    [],
], ids=["meta", "mixed", "empty"])
def test_levels_reject_what_no_path_takes(levels):
    with pytest.raises(ValueError):
        port.fast_nms_levels(levels, 20.0, 7.0)
