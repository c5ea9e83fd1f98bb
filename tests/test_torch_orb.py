"""The port's ORB extractor against the JAX package's.

- The constant tables (BRIEF pattern, blur-folded pattern bank, IC_Angle
  moment weights, disc half-widths, pyramid resize matrices) are rebuilt in
  the port from its own copy of ``pattern.py``; they must be bitwise equal.
- The port's copy of ``SyntheticWorld`` renders the same frames.
- On synthetic frames, the extractor gives equal ``valid`` and ``octave``,
  equal ``desc_bits`` and ``desc_pm1`` on valid slots, ``xy`` within
  1e-4 px (the pyramid's summation order moves level pixels by a few ulps,
  which moves the parabola refinement by ~3e-5 px), ``angle`` within 1e-5
  rad and ``response`` within 1e-2 (it comes back from an f32 priority key
  of magnitude ~5e4, whose ulp is 4e-3; no code reads it as a number).
- Fed JAX's own level image, the port's per-level selection and patch code
  give the same integer keypoint positions, isolating the pyramid.
- With Harris rescoring (``use_harris``) every output but ``response`` is
  bitwise the port's own output without it, and ``forward_batch`` bitwise
  ``forward``; against JAX the outputs hold the tolerances above, and
  ``response`` (now R ~ 1e-6, the 1/(4·7·255)² scale) is within 1e-6 of
  max|R|: the Harris sums are the same adds in the same order, but XLA's
  fused products round ~1.5e-7 of max|R| apart from torch's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _default_cfg
from se2lam_tpu.frontend import orb as jorb, pattern as jpattern
from se2lam_tpu.frontend.fast import fast_score_pair, nms3x3
from se2lam_tpu.io.synthetic import SyntheticWorld as JaxWorld
from se2lam_tpu_torch.entry import default_cfg
from se2lam_tpu_torch.frontend import orb as torb, pattern as tpattern
from se2lam_tpu_torch.io.synthetic import SyntheticWorld as TorchWorld

torch.set_num_threads(2)

SMALL = dict(width=320, height=240, n_features=300, n_levels=3)
BENCH = {}


@pytest.mark.parametrize("name", [
    "PATTERN", "PATTERN_X", "PATTERN_Y", "_GAUSS7", "_DISC_U", "_pattern_bank",
    "_moment_weights",
])
def test_constant_tables_bitwise(name):
    jmod = jpattern if name.startswith("PATTERN") else jorb
    tmod = tpattern if name.startswith("PATTERN") else torb
    want, got = getattr(jmod, name), getattr(tmod, name)
    if callable(want):
        want, got = want(), got()
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [SMALL, BENCH], ids=["small", "bench"])
def test_resize_buffers_bitwise(kw):
    _, joc = _default_cfg(**kw)
    _, toc = default_cfg(**kw)
    ext = torb.OrbExtractor(toc, device="cpu")
    assert toc.level_shapes == [
        (int(round(joc.height / s)), int(round(joc.width / s))) for s in joc.scales]
    assert toc.level_quotas == joc.level_quotas and toc.n_slots == joc.n_slots
    for lv, (H, W) in enumerate(toc.level_shapes[1:], start=1):
        np.testing.assert_array_equal(
            getattr(ext, f"resize_h{lv}").numpy(), jorb._resize_matrix(H, joc.height))
        np.testing.assert_array_equal(
            getattr(ext, f"resize_w{lv}").numpy(), jorb._resize_matrix(W, joc.width))
    bank = jnp.asarray(jorb._PATTERN_BANK, jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(ext.pattern_bank.numpy(), np.asarray(bank))


@pytest.mark.parametrize("dist", [None, (-0.2, 0.05, 1e-3, -1e-3, 0.0)],
                         ids=["pinhole", "distorted"])
def test_synthetic_world_renders_the_same_frames(dist):
    jcfg, _ = _default_cfg(**SMALL)
    tcfg, _ = default_cfg(**SMALL)
    if dist is not None:
        jcfg, tcfg = jcfg.replace(dist=dist), tcfg.replace(dist=dist)
    jw, tw = JaxWorld(jcfg, n_landmarks=300, seed=3), TorchWorld(tcfg, n_landmarks=300, seed=3)
    np.testing.assert_array_equal(tw.landmarks, jw.landmarks)
    gt = jw.circle_trajectory(64, radius=2.5)
    np.testing.assert_array_equal(tw.circle_trajectory(64, radius=2.5), gt)
    for p in gt[::16]:
        # distorted positions come from f32 math in torch and in XLA: an ulp
        # at u ~ 300 px is 3e-5 px, which moves a bilinear splat weight by
        # as much and a pixel by up to 3e-5 x 235 gray of patch contrast
        tol = 0.0 if dist is None else 1e-2
        np.testing.assert_allclose(tw.render(p), jw.render(p), rtol=0, atol=tol)


def test_pack_bits_matches_jax():
    bits = np.random.default_rng(4).integers(0, 2, (50, 256)).astype(np.uint8)
    want = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    got = torb.pack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module", params=["small", "bench"])
def extracted(request):
    """Both extractors on three frames of the bench world."""
    kw = SMALL if request.param == "small" else BENCH
    jcfg, joc = _default_cfg(**kw)
    _, toc = default_cfg(**kw)
    world = JaxWorld(jcfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)
    jext = jax.jit(jorb.make_extractor(joc))
    text = torb.OrbExtractor(toc, device="cpu")
    out = []
    for i in ((0, 7, 40) if request.param == "small" else (0,)):
        img = world.render(gt[i])
        fj = jax.tree.map(np.asarray, jext(jnp.asarray(img)))
        ft = text(torch.from_numpy(img))
        out.append((fj, jorb.OrbFeatures(*[t.numpy() for t in ft]), ft))
    return out


def test_extractor_matches_jax(extracted):
    for fj, ft, raw in extracted:
        for k in jorb.OrbFeatures._fields:
            assert getattr(ft, k).dtype == getattr(fj, k).dtype, k
            assert getattr(ft, k).shape == getattr(fj, k).shape, k
        assert raw.desc_bits.dtype == torch.uint32 and raw.octave.dtype == torch.int32
        v = fj.valid
        assert v.sum() > 0.8 * v.size
        np.testing.assert_array_equal(ft.valid, fj.valid)
        np.testing.assert_array_equal(ft.octave, fj.octave)
        np.testing.assert_array_equal(ft.desc_bits[v], fj.desc_bits[v])
        np.testing.assert_array_equal(ft.desc_pm1, fj.desc_pm1)
        np.testing.assert_allclose(ft.xy[v], fj.xy[v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(ft.angle[v], fj.angle[v], rtol=0, atol=1e-5)
        np.testing.assert_allclose(ft.response[v], fj.response[v], rtol=0, atol=1e-2)


def _jax_level(joc, level, quota):
    """JAX's FAST, selection and patch code on one level image."""
    sh, sl = fast_score_pair(level, joc.fast_high, joc.fast_low)
    ys, xs, ys_f, xs_f, _, valid = jorb._select_level_keypoints(
        joc, nms3x3(sh), nms3x3(sl), sl, quota)
    angle, bits = jorb._moments_and_bits(level, ys, xs)
    return ys, xs, ys_f, xs_f, valid, angle, bits


def test_level_selection_on_jax_level_image():
    """JAX's own pyramid level in, the port's FAST, selection and patch
    code against JAX's: equal integer positions and bits."""
    from se2lam_tpu_torch.frontend.fast_nms import fast_nms

    jcfg, joc = _default_cfg(**SMALL)
    _, toc = default_cfg(**SMALL)
    world = JaxWorld(jcfg, n_landmarks=500, seed=0)
    img = jnp.asarray(world.render(world.circle_trajectory(352, radius=2.5)[3]))
    text = torb.OrbExtractor(toc, device="cpu")
    jax_level = jax.jit(_jax_level, static_argnums=(0, 2))
    hi = jax.lax.Precision.HIGHEST
    for lv, (H, W) in enumerate(toc.level_shapes):
        level = img
        if lv > 0:
            Rh = jnp.asarray(jorb._resize_matrix(H, joc.height))
            Rw = jnp.asarray(jorb._resize_matrix(W, joc.width))
            level = jnp.matmul(jnp.matmul(Rh, img, precision=hi), Rw.T, precision=hi)
        quota = joc.level_quotas[lv]
        ys, xs, ys_f, xs_f, valid, angle, bits = map(
            np.asarray, jax_level(joc, level, quota))
        tlevel = torch.from_numpy(np.array(level))

        # integer positions: the port's ys/xs before the subpixel offset
        tys, txs, tys_f, txs_f, _, tvalid = torb._select_level_keypoints(
            toc, *fast_nms(tlevel, toc.fast_high, toc.fast_low), quota)
        np.testing.assert_array_equal(tvalid.numpy(), valid)
        v = valid
        np.testing.assert_array_equal(tys.numpy()[v], ys[v])
        np.testing.assert_array_equal(txs.numpy()[v], xs[v])
        np.testing.assert_allclose(tys_f.numpy()[v], ys_f[v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(txs_f.numpy()[v], xs_f[v], rtol=0, atol=1e-4)

        got = text.extract_level(tlevel, lv)
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        np.testing.assert_array_equal(got["bits"].numpy()[v], bits[v])
        np.testing.assert_allclose(got["angle"].numpy()[v], angle[v], rtol=0, atol=1e-5)


def test_configs_agree_field_by_field():
    jcfg, joc = _default_cfg()
    tcfg, toc = default_cfg()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert toc._asdict() == {k: v for k, v in joc._asdict().items()
                             if k in toc._fields}
    # the JAX config's one field the port lacks is its TPU lowering switch
    assert set(joc._fields) - set(toc._fields) == {"use_pallas_fast"}


@pytest.mark.parametrize("n_levels", [9, 10])
def test_extractor_matches_jax_past_eight_levels(n_levels):
    """More pyramid levels than the FAST+NMS kernel's 8-entry level table
    (the card launches it once per group of 8): on the CPU the extractor
    still equals JAX's, with the exactness of ``test_extractor_matches_jax``.
    320x240: at 160x120 the top levels are too small for the JAX
    extractor's per-cell top-k (k=6 over a 1-pixel cell), which raises."""
    kw = dict(width=320, height=240, n_features=1000, n_levels=n_levels)
    jcfg, joc = _default_cfg(**kw)
    _, toc = default_cfg(**kw)
    assert toc.scale_factor == 1.2 and all(q > 0 for q in toc.level_quotas)
    world = JaxWorld(jcfg, n_landmarks=500, seed=0)
    img = world.render(world.circle_trajectory(352, radius=2.5)[0])
    fj = jax.tree.map(np.asarray, jax.jit(jorb.make_extractor(joc))(jnp.asarray(img)))
    ft = torb.OrbExtractor(toc, device="cpu")(torch.from_numpy(img))
    ft = jorb.OrbFeatures(*[t.numpy() for t in ft])
    v = fj.valid
    assert v.sum() > 0 and (fj.octave[v] == n_levels - 1).any()
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.octave, fj.octave)
    np.testing.assert_array_equal(ft.desc_bits[v], fj.desc_bits[v])
    np.testing.assert_array_equal(ft.desc_pm1, fj.desc_pm1)
    np.testing.assert_allclose(ft.xy[v], fj.xy[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft.angle[v], fj.angle[v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.response[v], fj.response[v], rtol=0, atol=1e-2)


HARRIS_RTOL = 1e-6   # of max|R| (module docstring)


@pytest.mark.parametrize("shape", [(120, 160), (37, 53), (240, 320)])
def test_harris_response_matches_jax(shape):
    """``_harris_response`` alone on a random image, at positions that run
    past the bottom and right edges (both clamp there)."""
    H, W = shape
    rng = np.random.default_rng(H)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    ys, xs = rng.integers(0, H + 6, 400), rng.integers(0, W + 6, 400)
    want = np.asarray(jax.jit(jorb._harris_response)(jnp.asarray(img), jnp.asarray(ys),
                                                     jnp.asarray(xs)))
    got = torb._harris_response(torch.from_numpy(img), torch.from_numpy(ys),
                                torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HARRIS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("kw", [dict(width=160, height=120, n_features=300, n_levels=3),
                                dict(width=320, height=240, n_features=300, n_levels=3)],
                         ids=["160x120", "320x240"])
def test_harris_extractor_matches_jax(kw):
    jcfg, joc = _default_cfg(**kw)
    _, toc = default_cfg(**kw)
    joc, toc_h = joc._replace(use_harris=True), toc._replace(use_harris=True)
    world = JaxWorld(jcfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)
    imgs = torch.from_numpy(np.stack([world.render(gt[i]) for i in (0, 5, 9)]))
    ext, ext_off = torb.OrbExtractor(toc_h, device="cpu"), torb.OrbExtractor(toc, device="cpu")
    batch = ext.forward_batch(imgs)
    jext = jax.jit(jorb.make_extractor(joc))
    for i, img in enumerate(imgs):
        ft, off = ext(img), ext_off(img)
        for k in torb.OrbFeatures._fields:
            assert torch.equal(getattr(batch, k)[i], getattr(ft, k)), k
            if k != "response":
                assert torch.equal(getattr(ft, k), getattr(off, k)), k
        fj = jax.tree.map(np.asarray, jext(jnp.asarray(img.numpy())))
        ft = jorb.OrbFeatures(*[t.numpy() for t in ft])
        v = fj.valid
        assert v.sum() > 0.8 * v.size
        np.testing.assert_array_equal(ft.valid, fj.valid)
        np.testing.assert_array_equal(ft.octave, fj.octave)
        np.testing.assert_array_equal(ft.desc_bits[v], fj.desc_bits[v])
        np.testing.assert_allclose(ft.xy[v], fj.xy[v], rtol=0, atol=1e-4)
        np.testing.assert_allclose(ft.angle[v], fj.angle[v], rtol=0, atol=1e-5)
        scale = np.abs(fj.response[v]).max()
        assert 0 < scale < 1e-3
        np.testing.assert_allclose(ft.response[v], fj.response[v], rtol=0,
                                   atol=HARRIS_RTOL * scale)
