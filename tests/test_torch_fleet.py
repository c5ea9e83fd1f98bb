"""The port's batch extractor, batched windowed top-2 and fleet tracker.

- ``make_batch_extractor`` (``OrbExtractor.forward_batch``) at 320x240,
  300 features, 3 levels, on three uint8 frames: bitwise equal to
  ``OrbExtractor.forward`` frame by frame (the batch builds each frame's
  pyramid with ``forward``'s own products), and against
  the JAX package's ``make_batch_extractor`` with the tolerances of
  ``tests/test_torch_orb.py`` (valid, octave and descriptors equal, xy
  within 1e-4 px, angle within 1e-5 rad, response within 1e-2).
- ``windowed_top2_batched`` (the plain version here) bitwise against
  ``windowed_top2`` robot by robot, directly and through ``torch.vmap``,
  with shared rows, at B = 1 and 3 and on all-ties inputs.
- ``make_fleet_tracker`` on the config of ``tests/test_fleet.py`` (B = 3
  robots, T = 4 steps, each robot on its own world): against the JAX
  fleet tracker with JAX's keys (need_kf equal, poses within 1e-6 as
  ``tests/test_torch_tracking.py``, n_matched within 1), and against each
  robot alone through the same fleet step at B = 1 and through
  ``tracking.track_frame`` (poses within 1e-5, the JAX test's tolerance;
  decisions and match counts equal).
- A mesh raises ``NotImplementedError``.
- The rewrites that let ``torch.vmap`` batch the fleets
  (``inv_psd_small``'s identity and ``preintegrate_se2``'s ``Ak``/``Bk``
  made from the input, ``_covis_kf_count``'s ``seen`` and the projection
  match's ``feat_match`` written out of place) bitwise against the
  in-place forms they replaced.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _default_cfg
from se2lam_tpu.frontend import orb as jorb
from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu.parallel import make_fleet_tracker as jax_fleet_tracker
from se2lam_tpu_torch import tracking
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.entry import default_cfg
from se2lam_tpu_torch.frontend import orb as torb
from se2lam_tpu_torch.frontend import windowed_match as W
from se2lam_tpu_torch.kernels.samples import k2_robot_inputs
from se2lam_tpu_torch.parallel import make_fleet_localizer, make_fleet_tracker, shard_fleet
from se2lam_tpu_torch.system import SlamSystem

from test_fleet import fleet_cfg

torch.set_num_threads(2)

SMALL = dict(width=320, height=240, n_features=300, n_levels=3)


def test_batch_extractor_matches_forward_and_jax():
    jcfg, joc = _default_cfg(**SMALL)
    _, toc = default_cfg(**SMALL)
    world = SyntheticWorld(jcfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)
    imgs = np.stack([world.render(gt[i]) for i in (0, 7, 40)]).astype(np.uint8)
    extract = torb.make_batch_extractor(toc, device="cpu")
    fb = extract(imgs)
    assert fb.xy.shape == (3, toc.n_slots, 2) and fb.desc_bits.dtype == torch.uint32
    for i in range(3):
        f1 = extract.extractor(torch.from_numpy(imgs[i]))
        for name in torb.OrbFeatures._fields:
            assert torch.equal(getattr(fb, name)[i], getattr(f1, name)), (i, name)
    fj = jax.tree.map(np.asarray, jorb.make_batch_extractor(joc)(jnp.asarray(imgs)))
    ft = jorb.OrbFeatures(*[t.numpy() for t in fb])
    v = fj.valid
    assert v.sum() > 0.8 * v.size
    np.testing.assert_array_equal(ft.valid, fj.valid)
    np.testing.assert_array_equal(ft.octave, fj.octave)
    np.testing.assert_array_equal(ft.desc_bits[v], fj.desc_bits[v])
    np.testing.assert_array_equal(ft.desc_pm1, fj.desc_pm1)
    np.testing.assert_allclose(ft.xy[v], fj.xy[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ft.angle[v], fj.angle[v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.response[v], fj.response[v], rtol=0, atol=1e-2)


@pytest.mark.parametrize("B,N1,N2,pool", [(1, 200, 150, None), (3, 200, 150, None),
                                          (3, 300, 33, 1)],
                         ids=["B1", "B3", "B3_all_ties"])
def test_batched_k2_plain_matches_unbatched(B, N1, N2, pool):
    args, singles = k2_robot_inputs(B, N1, N2, pool=64 if pool is None else pool)
    got = W.windowed_top2_batched(*args)
    vm = torch.vmap(W.windowed_top2, in_dims=(None, 0, None, None, None, 0, 0, 0, 0, 0))(*args)
    for b, one in enumerate(singles):
        want = W.windowed_top2(*one)
        for o, v, w in zip(got, vm, want):
            assert o.dtype == w.dtype and torch.equal(o[b], w) and torch.equal(v[b], w)
    if pool == 1:
        assert bool((got[0] < 1e9).any()) and bool((got[1] == got[0]).any())


def _streams(cfg, B, T):
    """Robot b on SyntheticWorld(seed=b), T+1 frames of a 96-pose circle."""
    imgs, odos = [], []
    for b in range(B):
        w = SyntheticWorld(cfg, n_landmarks=300, seed=b)
        gt = w.circle_trajectory(96, radius=2.0)[:T + 1]
        imgs.append(np.stack([w.render(g) for g in gt]))
        odos.append(gt)
    return np.stack(imgs), np.stack(odos).astype(np.float32)


def test_fleet_tracker_matches_jax_and_each_robot():
    jcfg, joc = fleet_cfg()
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    oc = torb.OrbConfig(**{k: getattr(joc, k) for k in torb.OrbConfig._fields})
    B, T = 3, 4
    imgs, odos = _streams(jcfg, B, T)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    noise = torch.stack([torch.from_numpy(np.array(jax.random.gumbel(
        k, (cfg.cap.ransac_trials, oc.n_slots), jnp.float32))) for k in keys])

    j_init, j_step, j_extract = jax_fleet_tracker(jcfg, joc)
    jts = j_init(j_extract(jnp.asarray(imgs[:, 0])), jnp.asarray(odos[:, 0]),
                 jnp.asarray(odos[:, 0]))
    init_fn, step_fn, extract_fn = make_fleet_tracker(cfg, oc, device="cpu")
    tts = init_fn(extract_fn(imgs[:, 0]), odos[:, 0], odos[:, 0])
    alone = [init_fn(extract_fn(imgs[b:b + 1, 0]), odos[b:b + 1, 0], odos[b:b + 1, 0])
             for b in range(B)]
    plain = [tracking.init_track_state(tracking.chunk_frame(extract_fn(imgs[b:b + 1, 0]), 0),
                                       odos[b, 0], odos[b, 0], 0, torch.zeros((oc.n_slots, 3)),
                                       torch.zeros(oc.n_slots, dtype=torch.bool))
             for b in range(B)]
    matched = 0
    for t in range(1, T + 1):
        jts, jr = j_step(jts, jnp.asarray(imgs[:, t]), jnp.asarray(odos[:, t]), keys)
        tts, tr = step_fn(tts, imgs[:, t], odos[:, t], noise)
        assert tr.need_kf.tolist() == np.asarray(jr.need_kf).tolist()
        np.testing.assert_allclose(tr.pose.numpy(), np.asarray(jr.pose), rtol=0, atol=1e-6)
        assert np.abs(tr.n_matched.numpy() - np.asarray(jr.n_matched)).max() <= 1
        matched += int(tr.n_matched.sum())
        for b in range(B):
            alone[b], ar = step_fn(alone[b], imgs[b:b + 1, t], odos[b:b + 1, t], noise[b:b + 1])
            feats = tracking.chunk_frame(extract_fn(imgs[b:b + 1, t]), 0)
            plain[b], pr = tracking.track_frame(plain[b], feats, torch.from_numpy(odos[b, t]),
                                                cfg, gumbel=noise[b])
            for r in (ar, pr):
                np.testing.assert_allclose(r.pose.reshape(3).numpy(), tr.pose[b].numpy(),
                                           rtol=0, atol=1e-5)
                assert bool(r.need_kf.reshape(())) == bool(tr.need_kf[b])
                assert int(r.n_matched.reshape(())) == int(tr.n_matched[b])
    assert matched > 0


def test_mesh_raises_not_implemented():
    cfg, _ = default_cfg(**SMALL)
    with pytest.raises(NotImplementedError, match="item 20"):
        make_fleet_tracker(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        make_fleet_localizer(cfg, None, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 20"):
        shard_fleet({}, object())
    with pytest.raises(NotImplementedError, match="item 20"):
        SlamSystem(cfg, mesh=object(), device="cpu")


# --- the rewrites that let torch.vmap batch the fleets: each against the
# in-place formulation it replaced, on unbatched inputs, bitwise


def _inv_psd_small_in_place(M, eps=1e-30):
    n = M.shape[-1]
    A = M.clone()
    I = torch.eye(n, dtype=M.dtype).expand(M.shape).clone()
    not_k = ~torch.eye(n, dtype=torch.bool)
    for k in range(n):
        piv = A[..., k, k]
        piv = torch.where(piv.abs() < eps, torch.full_like(piv, eps), piv)
        inv_piv = (1.0 / piv)[..., None]
        row_a, row_i = A[..., k, :] * inv_piv, I[..., k, :] * inv_piv
        A[..., k, :] = row_a
        I[..., k, :] = row_i
        factor = torch.where(not_k[k], A[..., :, k], torch.zeros_like(A[..., :, k]))[..., :, None]
        A = A - factor * row_a[..., None, :]
        I = I - factor * row_i[..., None, :]
    return I


def _preintegrate_in_place(meas, cov, d_odo, odo_noise):
    from se2lam_tpu_torch.ops import se2
    Phi = se2.rot2(meas[..., 2])
    dr = d_odo[..., :2]
    new_meas = torch.cat([meas[..., :2] + torch.einsum("...ij,...j->...i", Phi, dr),
                          (meas[..., 2] + d_odo[..., 2])[..., None]], dim=-1)
    eye = torch.eye(3, dtype=meas.dtype)
    dr_perp = torch.stack([-dr[..., 1], dr[..., 0]], dim=-1)
    Ak = eye.expand(cov.shape).clone()
    Ak[..., :2, 2] = torch.einsum("...ij,...j->...i", Phi, dr_perp)
    Bk = eye.expand(cov.shape).clone()
    Bk[..., :2, :2] = Phi
    Sigma_v = torch.diag_embed(odo_noise ** 2).expand(cov.shape)
    return new_meas, Ak @ cov @ Ak.transpose(-1, -2) + Bk @ Sigma_v @ Bk.transpose(-1, -2)


def _covis_in_place(ms, feat_match):
    K = ms.K
    sel = feat_match >= 0
    obs = ms.mp_obs_kf[feat_match.clamp(min=0).long()]
    ok = sel[:, None] & (obs >= 0) & ms.kf_valid[obs.clamp(min=0).long()]
    seen = torch.zeros(K + 1, dtype=torch.bool)
    seen[torch.where(ok, obs, torch.full_like(obs, K)).long()] = True
    return seen[:K].sum(dtype=torch.int32)


@pytest.mark.parametrize("what", ["inv_psd_small", "preintegrate_se2", "covis_kf_count",
                                  "feat_match"])
def test_vmap_rewrites_keep_the_unbatched_bits(what):
    from se2lam_tpu_torch import factors
    from se2lam_tpu_torch import localizer as tloc
    from se2lam_tpu_torch.config import Capacity
    from se2lam_tpu_torch.mapstate import empty_map
    from se2lam_tpu_torch.ops.linalg import inv_psd_small

    g = torch.Generator().manual_seed(5)
    if what == "inv_psd_small":
        for shape in [(9, 9), (64, 9, 9), (3, 3)]:
            A = torch.randn(shape, generator=g)
            M = A @ A.transpose(-1, -2) + torch.eye(shape[-1])
            assert torch.equal(inv_psd_small(M), _inv_psd_small_in_place(M))
    elif what == "preintegrate_se2":
        for lead in [(), (5,)]:
            args = (torch.randn(lead + (3,), generator=g), torch.randn(lead + (3, 3), generator=g),
                    torch.randn(lead + (3,), generator=g), torch.rand(3, generator=g))
            for a, b in zip(factors.preintegrate_se2(*args), _preintegrate_in_place(*args)):
                assert torch.equal(a, b)
    elif what == "covis_kf_count":
        ms = empty_map(Capacity(max_kfs=16, max_mps=64, n_features=32), device="cpu")
        ms = ms._replace(
            mp_obs_kf=torch.randint(-1, 16, tuple(ms.mp_obs_kf.shape), generator=g,
                                    dtype=torch.int32),
            kf_valid=torch.rand(16, generator=g) > 0.3)
        fm = torch.randint(-1, 64, (32,), generator=g, dtype=torch.int32)
        assert torch.equal(tloc._covis_kf_count(ms, fm), _covis_in_place(ms, fm))
    else:
        # the projection match's feature-to-point table, through K2's plain version
        args, _ = k2_robot_inputs(1, 300, 200, seed=3)
        feats = torb.OrbFeatures(
            xy=args[7][0], angle=torch.zeros(200), octave=args[8][0], response=torch.zeros(200),
            valid=args[9][0], desc_bits=torch.zeros((200, 8), dtype=torch.int32),
            desc_pm1=args[6][0])
        oct1 = args[3].to(torch.int32) + 2
        fm, n = W.match_by_projection_streamed(feats, args[1][0], oct1, args[0], args[5][0],
                                               feats.valid, level_offset=2)
        best, second, best_idx, second_idx = W.windowed_top2(*W.projection_match_inputs(
            feats, args[1][0], oct1, args[0], args[5][0], feats.valid, level_offset=2))
        assert int(n) > 0
        M = args[0].shape[0]
        accept = torch.zeros(M, dtype=torch.bool)
        accept[fm[fm >= 0].long()] = True
        want = torch.full((201,), -1, dtype=torch.int32)
        want[torch.where(accept, best_idx, torch.full_like(best_idx, 200)).long()] = torch.where(
            accept, torch.arange(M, dtype=torch.int32), torch.full((M,), -1, dtype=torch.int32))
        assert torch.equal(fm, want[:200])
