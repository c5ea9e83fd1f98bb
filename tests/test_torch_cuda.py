"""Tests that need the card: the CUDA kernels against their plain versions,
and the port's extractor on the card against the same extractor on the CPU
(whose plain path the other tests hold against the JAX package).

They import no JAX, so they run where JAX is not installed; there the JAX
conftest is skipped: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
Without a card they skip.
"""
import numpy as np
import pytest
import torch

from se2lam_tpu_torch import tracking
from se2lam_tpu_torch.entry import default_cfg
from se2lam_tpu_torch.frontend import fast_nms as K1
from se2lam_tpu_torch.frontend import windowed_match as K2
from se2lam_tpu_torch.frontend.orb import OrbExtractor
from se2lam_tpu_torch.io.synthetic import SyntheticWorld
from se2lam_tpu_torch.kernels.samples import k2_inputs, k2_robot_inputs
from se2lam_tpu_torch.solver import ba
from se2lam_tpu_torch.solver import schur as K3

BENCH_LEVELS = [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309)]
# one 40x72 input tile, and (32, 64) exactly one 64x32 output tile
RAGGED_LEVELS = [(231, 309), (17, 33), (8, 8), (40, 72), (32, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def sprinkled_image(rng, H, W):
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    for _ in range(30):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 1: y + 2, x - 1: x + 2] = 250.0
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BENCH_LEVELS + [(17, 33), (8, 8)])
def test_kernel_matches_plain_on_card(card, shape):
    """Bitwise over the whole map, the image border and ragged tiles too."""
    img = torch.from_numpy(sprinkled_image(np.random.default_rng(2), *shape)
                           if min(shape) > 40 else
                           np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32))
    img = img.to(card)
    before = K1.fast_nms.launches
    got = K1.fast_nms(img, 20.0, 7.0)
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 1
    for g, w in zip(got, K1.fast_nms_plain(img, 20.0, 7.0)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [BENCH_LEVELS, RAGGED_LEVELS], ids=["bench", "ragged"])
def test_levels_kernel_matches_plain_in_one_launch(card, shapes):
    """All levels in one launch, each bitwise equal to the plain version
    over its whole map: the bench's five levels, and a ragged table whose
    tile index crosses level boundaries, with levels smaller than a tile
    and one exactly a tile."""
    rng = np.random.default_rng(4)
    levels = [torch.from_numpy(sprinkled_image(rng, *s) if min(s) > 40 else
                               rng.uniform(0, 255, s).astype(np.float32)).to(card)
              for s in shapes]
    before = K1.fast_nms.launches
    got = K1.fast_nms_levels(levels, 20.0, 7.0)
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 1
    for lv, maps in zip(levels, got):
        for g, w in zip(maps, K1.fast_nms_plain(lv, 20.0, 7.0)):
            assert g.shape == lv.shape and torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError):
        K1.fast_nms(torch.zeros((64, 64), dtype=torch.float64, device=card), 20.0, 7.0)
    with pytest.raises(ValueError):
        K1.fast_nms(torch.zeros((64, 128), device=card)[:, ::2], 20.0, 7.0)
    ok = torch.zeros((64, 64), device=card)
    for levels in ([ok, torch.zeros((64, 64), dtype=torch.float64, device=card)],
                   [ok, torch.zeros((64, 128), device=card)[:, ::2]],
                   [ok, torch.zeros((64, 64))]):
        with pytest.raises(ValueError):
            K1.fast_nms_levels(levels, 20.0, 7.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_levels", [9, 10])
def test_levels_past_the_table_launch_per_group(card, n_levels):
    """More levels than the kernel's 8-entry table: one launch per group of
    8, every level bitwise equal to the plain version; the extractor's
    forward pass at that depth launches the same two."""
    cfg, oc = default_cfg(n_levels=n_levels)
    ext = OrbExtractor(oc, device=card)
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    img = torch.from_numpy(world.render(world.circle_trajectory(352, radius=2.5)[0])).to(card)
    levels = [lv.contiguous() for lv in ext.pyramid(img)]
    assert len(levels) == n_levels
    before = K1.fast_nms.launches
    got = K1.fast_nms_levels(levels, 20.0, 7.0)
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 2
    for lv, maps in zip(levels, got):
        for g, w in zip(maps, K1.fast_nms_plain(lv, 20.0, 7.0)):
            assert g.shape == lv.shape and torch.equal(g, w)
    before = K1.fast_nms.launches
    feats = ext(img)
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 2
    assert int((feats.octave[feats.valid] == n_levels - 1).sum()) > 0


@pytest.mark.cuda
def test_extractor_on_card_matches_cpu(card):
    cfg, oc = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    img = torch.from_numpy(world.render(world.circle_trajectory(352, radius=2.5)[5]))
    fc = OrbExtractor(oc, device="cpu")(img)
    fg = OrbExtractor(oc, device=card)(img.to(card))
    v = fc.valid
    assert torch.equal(fg.valid.cpu(), v) and torch.equal(fg.octave.cpu(), fc.octave)
    torch.testing.assert_close(fg.xy.cpu()[v], fc.xy[v], rtol=0, atol=1e-3)
    same = (fg.desc_bits.cpu().view(torch.int32) == fc.desc_bits.view(torch.int32)).all(1)
    assert same[v].float().mean() > 0.99


def _schur_inputs(K, M, seed=0):
    g = torch.Generator().manual_seed(seed)
    Hpx = torch.randn((K, 3, M, 3), generator=g)
    L = torch.randn((M, 3, 3), generator=g)
    Hxx_inv = torch.linalg.inv(L @ L.transpose(-1, -2) + torch.eye(3)).contiguous()
    return Hpx, Hxx_inv


@pytest.mark.cuda
@pytest.mark.parametrize("K,M", [(4, 12), (8, 130), (24, 512), (48, 2048), (33, 1001),
                                 (256, 8192), (2, 1000), (2, 130), (2, 7)])
def test_schur_kernel_matches_plain_on_card(card, K, M):
    """Within 1e-5 of the largest entry of the plain einsum pair evaluated
    in f64 on the same f32 inputs (the JAX package's kernel tolerance); the
    same bits on a second launch."""
    Hpx, Hxx_inv = (a.to(card) for a in _schur_inputs(K, M))
    before = K3.point_reduction.launches
    got = K3.point_reduction(Hpx, Hxx_inv)
    again = K3.point_reduction(Hpx, Hxx_inv)
    want = K3.point_reduction_plain(Hpx.double(), Hxx_inv.double())
    torch.cuda.synchronize()
    assert K3.point_reduction.launches == before + 2
    assert got.shape == (K, K, 3, 3)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("K,M,zero_from,spd", [
    (6, 40, 20, False), (8, 130, 65, True), (8, 130, 96, True), (8, 132, 64, True),
], ids=["identity", "mid_chunk", "chunk_boundary", "aligned"])
def test_schur_kernel_zero_columns_add_nothing(card, K, M, zero_from, spd):
    """Point columns zeroed from ``zero_from`` on give the same bits as the
    call that stops there: the kernel's chunks sit at absolute offsets."""
    Hpx, Hxx_inv = _schur_inputs(K, M)
    Hpx[:, :, zero_from:] = 0.0
    if not spd:
        Hxx_inv = torch.eye(3).expand(M, 3, 3).contiguous()
    Hpx, Hxx_inv = Hpx.to(card), Hxx_inv.to(card)
    full = K3.point_reduction(Hpx, Hxx_inv)
    part = K3.point_reduction(Hpx[:, :, :zero_from].contiguous(),
                              Hxx_inv[:zero_from].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(full, part)


@pytest.mark.cuda
@pytest.mark.parametrize("K,M", [(4, 12), (33, 1001), (48, 2048)])
def test_schur_kernel_symmetric_off_diagonal_blocks(card, K, M):
    """The kernel computes the upper triangle of tiles and mirrors it, so
    S_red[k, l] is bitwise S_red[l, k]ᵀ for every k != l."""
    Hpx, Hxx_inv = (a.to(card) for a in _schur_inputs(K, M, seed=1))
    S = K3.point_reduction(Hpx, Hxx_inv)
    off = ~torch.eye(K, dtype=torch.bool, device=card)
    assert torch.equal(S[off], S.permute(1, 0, 3, 2)[off])


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [False, True], ids=["scatter", "grid"])
def test_local_ba_on_card_runs_the_kernel(card, grid):
    """``solve_local_ba`` on the card through both assembly branches (the
    M×P grid one is what the joint global BA sets): one Schur launch an LM
    step, chi2 down by more than 4 orders, the poses within 1e-4 of the
    same solve on the CPU. The card's atomics reorder f32 sums, so the two
    solves are held by tolerance, not bitwise."""
    cfg, _ = default_cfg()
    K, M, P, iters = 12, 60, 6, 10
    ba_cfg = ba.BAConfig(iters=iters, obs_grid_p=P if grid else 0)
    solved = {}
    for dev in (card, torch.device("cpu")):
        c = tracking.constants(cfg, dev)
        prob, true_poses = ba.synthetic_grid_ba(np.random.default_rng(3), K, M, P,
                                                c["cam"], c["Tcb"])
        before = K3.point_reduction.launches
        poses, _, info = ba.solve_local_ba(prob, c["cam"], c["Tcb"], ba_cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert K3.point_reduction.launches == before + iters
        assert float(info["chi2"]) < 1e-4 * float(info["chi2_init"]), info
        solved[dev.type] = poses.cpu()
    torch.testing.assert_close(solved["cuda"], solved["cpu"], rtol=0, atol=1e-4)
    torch.testing.assert_close(solved["cuda"], true_poses.cpu(), rtol=0, atol=5e-3)


@pytest.mark.cuda
def test_schur_kernel_rejects_what_it_does_not_take(card):
    Hpx, Hxx_inv = (a.to(card) for a in _schur_inputs(4, 12))
    with pytest.raises(ValueError):
        K3.point_reduction(Hpx.double(), Hxx_inv.double())
    with pytest.raises(ValueError):
        K3.point_reduction(Hpx, Hxx_inv.transpose(-1, -2))


@pytest.mark.cuda
@pytest.mark.parametrize("N1,N2,pool", [
    (8192, 1000, 64), (8191, 997, 64), (1, 1, 64),
    (300, 1, 1), (300, 31, 1), (300, 32, 1), (300, 33, 1), (300, 997, 1),
])
def test_windowed_top2_matches_plain_on_card(card, N1, N2, pool):
    """All four outputs exactly equal to the plain version on the card,
    ties included (with ``pool=1`` every gated distance ties); the same
    bits on a second launch."""
    x = [a.to(card) for a in k2_inputs(N1, N2, pool=pool)]
    before = K2.windowed_top2.launches
    got = K2.windowed_top2(*x)
    again = K2.windowed_top2(*x)
    want = K2.windowed_top2_plain(*x)
    torch.cuda.synchronize()
    assert K2.windowed_top2.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, a)
    if N2 >= 997:
        assert int((got[0] < 1e9).sum()) > 100 and bool((got[0] == got[1]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 64])
@pytest.mark.parametrize("cols", [[40, 41, 45, 47, 63], [3, 70, 500, 996],
                                  [0, 31, 32, 33, 995, 996], list(range(5, 997, 9))],
                         ids=["one_group", "spread", "group_edges", "many"])
def test_windowed_top2_gated_columns_of_one_row(card, cols, pool):
    """Row 0's gated columns inside one 32-column group of the kernel's
    walk, spread across groups, on group edges, or more than its queue
    takes at once: all four outputs equal to the plain version."""
    N2 = 997
    x = k2_inputs(16, N2, seed=4, pool=pool)
    x[5][0] = True
    x[7] = torch.full((N2, 2), 1e4)               # every column far from every row ...
    x[7][cols] = x[1][0]                          # ... but these, on row 0's prediction
    x[8] = torch.full((N2,), int(x[3][0]), dtype=torch.int32)
    x[9] = torch.ones(N2, dtype=torch.bool)
    x = [a.to(card) for a in x]
    got = K2.windowed_top2(*x)
    want = K2.windowed_top2_plain(*x)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[2][0]) in cols and int(got[3][0]) in cols


@pytest.mark.cuda
def test_windowed_top2_all_gated_rows(card):
    x = [a.to(card) for a in k2_inputs(300, 200, seed=1)]
    x[2] = torch.full_like(x[2], -1.0)                 # a negative window admits nothing
    best, second, arg, arg2 = K2.windowed_top2(*x)
    torch.cuda.synchronize()
    assert bool((best == 1e9).all()) and bool((second == 1e9).all())
    assert not bool(arg.any()) and not bool(arg2.any())


@pytest.mark.cuda
def test_windowed_top2_rejects_what_it_does_not_take(card):
    x = [a.to(card) for a in k2_inputs(64, 32, seed=2)]
    bad_dtype = list(x)
    bad_dtype[0] = x[0].to(torch.float32)
    with pytest.raises(ValueError):
        K2.windowed_top2(*bad_dtype)
    strided = list(x)
    strided[1] = torch.zeros((64, 4), device=card)[:, ::2]
    with pytest.raises(ValueError):
        K2.windowed_top2(*strided)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N1,N2,pool", [
    (1, 8192, 1000, 64), (3, 8192, 1000, 64), (3, 300, 33, 1), (3, 300, 997, 1),
], ids=["B1", "B3", "B3_ties_33", "B3_ties_997"])
def test_windowed_top2_batched_equals_single_launches(card, B, N1, N2, pool):
    """One launch for B robots on shared rows: robot b's four outputs are
    bitwise those of a single launch on its inputs, and of the batched
    plain version (all-ties inputs with ``pool=1``)."""
    args, singles = k2_robot_inputs(B, N1, N2, seed=6, pool=pool)
    args = [a.to(card) for a in args]
    before = K2.windowed_top2.launches
    got = K2.windowed_top2_batched(*args)
    torch.cuda.synchronize()
    assert K2.windowed_top2.launches == before + 1
    plain = K2.windowed_top2_batched_plain(*args)
    vm = torch.vmap(K2.windowed_top2, in_dims=(None, 0, None, None, None, 0, 0, 0, 0, 0))(*args)
    assert K2.windowed_top2.launches == before + 2      # the vmap: one batched launch
    for b, one in enumerate(singles):
        want = K2.windowed_top2(*[a.to(card) for a in one])
        for g, p, v, w in zip(got, plain, vm, want):
            assert g.dtype == w.dtype and torch.equal(g[b], w)
            assert torch.equal(p[b], w) and torch.equal(v[b], w)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 64])
def test_windowed_top2_batched_gated_columns(card, pool):
    """Each robot's row 0 gated on its own columns: inside one 32-column
    group, spread over several, on group edges, more than the queue takes."""
    cols = [[40, 41, 45, 47, 63], [3, 70, 500, 996], [0, 31, 32, 33, 995, 996],
            list(range(5, 997, 9))]
    B, N2 = len(cols), 997
    args, _ = k2_robot_inputs(B, 16, N2, seed=4, pool=pool)
    args[5][:, 0] = True
    args[7] = torch.full((B, N2, 2), 1e4)
    for b, c in enumerate(cols):
        args[7][b, c] = args[1][b, 0]
    args[8] = torch.full((B, N2), int(args[3][0]), dtype=torch.int32)
    args[9] = torch.ones((B, N2), dtype=torch.bool)
    args = [a.to(card) for a in args]
    got = K2.windowed_top2_batched(*args)
    want = K2.windowed_top2_batched_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for b, c in enumerate(cols):
        assert int(got[2][b, 0]) in c and int(got[3][b, 0]) in c


@pytest.mark.cuda
def test_batch_extractor_launches_and_equals_forward(card):
    """k = 3 bench frames in one batched extraction: ⌈5·3/8⌉ = 2 K1
    launches, and frame by frame bitwise the features of ``forward`` (the
    batch builds each frame's pyramid with ``forward``'s own products)."""
    from se2lam_tpu_torch.frontend.orb import make_batch_extractor

    cfg, oc = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)
    imgs = torch.from_numpy(np.stack([world.render(gt[i]) for i in (0, 5, 9)])
                            .astype(np.uint8)).to(card)
    extract = make_batch_extractor(oc, device=card)
    before = K1.fast_nms.launches
    fb = extract(imgs)
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 2
    for i in range(3):
        f1 = extract.extractor(imgs[i])
        for name in f1._fields:
            assert torch.equal(getattr(fb, name)[i], getattr(f1, name)), (i, name)


def _random_map(cfg, card, seed=3):
    from se2lam_tpu_torch.mapstate import empty_map

    rng = np.random.default_rng(seed)
    M = cfg.cap.max_mps
    ms = empty_map(cfg.cap, device=card)
    return ms._replace(
        mp_pos=torch.from_numpy(np.stack([rng.uniform(1, 6, M), rng.uniform(-2, 2, M),
                                          rng.uniform(-1, 1, M)], 1).astype(np.float32)).to(card),
        mp_valid=torch.ones(M, dtype=torch.bool, device=card),
        mp_desc=torch.from_numpy((1 - 2 * rng.integers(0, 2, (M, 256))).astype(np.int8)).to(card),
    )


@pytest.mark.cuda
def test_fleet_localization_launches_k2_once_a_chunk_step(card):
    """B = 3 robots x k = 2 frames against one map: one K2 launch a chunk
    step for the whole fleet, and ⌈5·6/8⌉ = 4 K1 launches for the frames."""
    from se2lam_tpu_torch.parallel import make_fleet_localizer

    cfg, _ = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    poses = np.asarray([[0.05 * j, 0.0, 0.01 * j] for j in range(1, 3)], np.float32)
    imgs = np.stack([np.stack([world.render(p) for p in poses])] * 3)
    extract_fn, step_fn = make_fleet_localizer(cfg, _random_map(cfg, card), device=card)
    k1, k2 = K1.fast_nms.launches, K2.windowed_top2.launches
    feats = extract_fn(torch.from_numpy(imgs).to(card))
    out, tracked = step_fn(np.zeros((3, 3), np.float32), np.zeros((3, 3), np.float32), feats,
                           np.stack([poses] * 3))
    torch.cuda.synchronize()
    assert out.shape == (3, 2, 3) and tracked.shape == (3, 2)
    assert bool(torch.isfinite(out).all())
    assert K2.windowed_top2.launches == k2 + 2
    assert K1.fast_nms.launches == k1 + 4


@pytest.mark.cuda
def test_localizer_step_launches_k2_once(card):
    """One tracked Localizer frame on the card: one projection match, so
    exactly one K2 launch (and one of K1, for all pyramid levels of the
    extraction)."""
    from se2lam_tpu_torch.localizer import Localizer
    from se2lam_tpu_torch.mapstate import empty_map

    cfg, _ = default_cfg()
    rng = np.random.default_rng(3)
    M = cfg.cap.max_mps
    ms = empty_map(cfg.cap, device=card)
    ms = ms._replace(
        mp_pos=torch.from_numpy(np.stack([rng.uniform(1, 6, M), rng.uniform(-2, 2, M),
                                          rng.uniform(-1, 1, M)], 1).astype(np.float32)).to(card),
        mp_valid=torch.ones(M, dtype=torch.bool, device=card),
        mp_desc=torch.from_numpy((1 - 2 * rng.integers(0, 2, (M, 256))).astype(np.int8)).to(card),
    )
    with pytest.warns(UserWarning, match="without a vocabulary"):
        loc = Localizer(cfg, ms, device=card)
    loc.set_pose(np.zeros(3, np.float32), np.zeros(3, np.float32))
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    img = torch.from_numpy(world.render(np.asarray([0.05, 0.0, 0.01], np.float32))).to(card)
    k1, k2 = K1.fast_nms.launches, K2.windowed_top2.launches
    loc.process(img, np.asarray([0.05, 0.0, 0.01], np.float32))
    torch.cuda.synchronize()
    assert K2.windowed_top2.launches == k2 + 1
    assert K1.fast_nms.launches == k1 + 1


@pytest.fixture(scope="module")
def small_map():
    """A map the port's SlamSystem (loops off) builds on the CPU: 40 frames
    of the bench world at 320x240, 256 features, 2 levels, 32 keyframe and
    2048 point slots."""
    import dataclasses

    from se2lam_tpu_torch.system import SlamSystem

    torch.set_num_threads(4)
    cfg, _ = default_cfg(width=320, height=240, n_features=256, n_levels=2)
    cfg = cfg.replace(min_frames_between_kf=2, max_frames_between_kf=8,
                      cap=dataclasses.replace(cfg.cap, max_kfs=32, max_mps=2048, local_kfs=8,
                                              local_ref_kfs=8, local_mps=512,
                                              ransac_trials=64))
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    slam = SlamSystem(cfg, enable_loops=False, device="cpu")
    gt = world.circle_trajectory(352, radius=2.5)[:40]
    for img, odo in zip((world.render(p) for p in gt), world.odometry(gt, seed=1)):
        slam.process(img, odo)
    assert slam.n_keyframes() >= 4
    return cfg, slam


@pytest.mark.cuda
def test_joint_global_ba_on_card_runs_the_kernel(card, small_map):
    """``run_global_ba_joint`` on a real map: one Schur launch per LM step
    at (max_kfs, max_mps), the result within 2e-3 of the CPU solve (the
    card's atomics reorder f32 sums)."""
    from se2lam_tpu_torch import loopclose
    from se2lam_tpu_torch.mapstate import MapState

    cfg, slam = small_map
    ms_card = MapState(*(t.to(card) for t in slam.ms))
    seen = []
    orig = ba.schur_reduce

    def spy(Hpp, bp, Hpx, Hxx_inv, bx):
        seen.append((Hpx.shape[0], Hpx.shape[2]))
        return orig(Hpp, bp, Hpx, Hxx_inv, bx)

    before = K3.point_reduction.launches
    ba.schur_reduce = spy
    try:
        got, info = loopclose.run_global_ba_joint(ms_card, cfg, iters=5)
        torch.cuda.synchronize()
    finally:
        ba.schur_reduce = orig
    assert K3.point_reduction.launches == before + 5
    assert set(seen) == {(cfg.cap.max_kfs, cfg.cap.max_mps)}
    want, winfo = loopclose.run_global_ba_joint(slam.ms, cfg, iters=5)
    assert float(info["chi2"]) <= float(info["chi2_init"])
    torch.testing.assert_close(got.kf_pose.cpu(), want.kf_pose, rtol=0, atol=2e-3)
    torch.testing.assert_close(info["chi2"].cpu(), winfo["chi2"], rtol=1e-2, atol=1e-3)


@pytest.mark.cuda
def test_loop_stage_on_card(card, small_map):
    """One ``loop_stage`` call on the card at the newest keyframe, with a
    vocabulary trained there: the bank row of the keyframe, the decisions
    read back once, a finite map; with the same RANSAC noise as a CPU call
    on the same inputs, the same decisions."""
    from se2lam_tpu_torch import loopclose, vocab as vocab_mod
    from se2lam_tpu_torch.mapstate import MapState

    cfg, slam = small_map
    k = slam._ref_kf_host
    g = torch.Generator().manual_seed(5)
    noise = -torch.log(torch.empty((5, cfg.cap.ransac_trials, cfg.cap.n_features))
                       .exponential_(generator=g))
    outs = {}
    for dev in (card, torch.device("cpu")):
        ms = MapState(*(t.to(dev) for t in slam.ms))
        valid = (ms.kf_feat_valid & ms.kf_valid[:, None]).reshape(-1)
        vocab = vocab_mod.train_vocab(ms.kf_desc.reshape(-1, 256), valid, n_words=256,
                                      seed_idx=torch.nonzero(valid)[:256, 0].to(dev))
        bank, _ = vocab_mod.bow_transform(vocab, ms.kf_desc, ms.kf_feat_valid & ms.kf_valid[:, None])
        ms2, bank2, out = loopclose.loop_stage(
            ms, k, bank, vocab, torch.tensor([-1, -1], dtype=torch.int32, device=dev), False, cfg,
            n_trials=cfg.cap.ransac_trials, gba_iters=cfg.global_iter,
            joint_iters=cfg.gm_joint_ba_iters, min_between=5, gumbel=noise.to(dev))
        assert bool(torch.isfinite(ms2.kf_pose).all()) and bool(torch.isfinite(ms2.mp_pos).all())
        assert torch.equal(bank2[k], bank[k])
        outs[dev.type] = out
    for name in ("fired", "cand", "k", "renewal_gba", "cooldown"):
        assert outs["cuda"][name] == outs["cpu"][name], name
    assert outs["cuda"]["k"] == k


@pytest.mark.cuda
def test_stage_timer_synchronises_the_card(card, monkeypatch):
    """``StageTimer(block=True)`` waits for the devices of a timed call's
    output before it stops the clock, and only then; ``measure_rtt`` reads
    a scalar back from the card."""
    from se2lam_tpu_torch.utils import timing

    synced = []
    orig = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: (synced.append(d), orig(d)))
    a = torch.ones((512, 512), device=card)
    timing.StageTimer(block=False).timed("mm", torch.mm, a, a)
    assert synced == []
    st = timing.StageTimer(block=True)
    out = st.timed("mm", lambda x: {"y": [x @ x], "z": 1}, a)
    assert [torch.device(d) for d in synced] == [out["y"][0].device]
    assert st.samples["mm"][0] > 0.0
    assert 0.0 < timing.measure_rtt(reps=3) < 1.0


def _tiny_merge_cfg():
    """The configuration of the JAX package's tests/test_mapmerge.py
    (160x120, 128 features, 2 levels), built from the port's classes."""
    from se2lam_tpu_torch.config import Capacity, SystemConfig
    from se2lam_tpu_torch.frontend.orb import OrbConfig

    Tcb = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64)
    oc = OrbConfig(height=120, width=160, n_features=128, scale_factor=1.2, n_levels=2)
    return SystemConfig(
        width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
        Tbc=tuple(np.linalg.inv(Tcb).ravel()), upper_depth=30.0, lower_depth=0.2,
        max_feature_num=128, max_level=2, min_frames_between_kf=2, max_frames_between_kf=5,
        local_iter=4, gm_vcl_num_min_match_kp=12, gm_vcl_num_min_match_mp=5,
        cap=Capacity(n_features=oc.n_slots, max_kfs=64, max_mps=2048, local_kfs=6,
                     local_ref_kfs=6, local_mps=256, ransac_trials=32))


@pytest.mark.cuda
def test_merge_on_card_runs_the_joint_gba_through_the_kernel(card):
    """``merge_maps`` on the card, of two half maps built on the CPU: the
    joint GBA launches the Schur kernel once an LM step at (max_kfs,
    max_mps), and the merged map holds both maps' keyframes."""
    from se2lam_tpu_torch.mapmerge import merge_maps
    from se2lam_tpu_torch.system import SlamSystem

    torch.set_num_threads(4)
    cfg = _tiny_merge_cfg()
    world = SyntheticWorld(cfg, n_landmarks=400, room=10.0, seed=2)
    gt = np.asarray(world.circle_trajectory(80))
    maps = []
    for frames in (range(0, 48), range(40, 80)):
        slam = SlamSystem(cfg, enable_loops=False, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        for i in frames:
            slam.process(world.render(gt[i]), np.asarray(gt[i], np.float32))
        maps.append(slam.ms)
    seen = []
    orig = ba.schur_reduce

    def spy(Hpp, bp, Hpx, Hxx_inv, bx):
        seen.append((Hpx.shape[0], Hpx.shape[2]))
        return orig(Hpp, bp, Hpx, Hxx_inv, bx)

    before = K3.point_reduction.launches
    ba.schur_reduce = spy
    try:
        merged, info = merge_maps(maps[0], maps[1], cfg,
                                  generator=torch.Generator(device=card).manual_seed(42))
        torch.cuda.synchronize()
    finally:
        ba.schur_reduce = orig
    assert merged.kf_pose.device.type == "cuda"
    assert K3.point_reduction.launches == before + cfg.gm_joint_ba_iters
    assert set(seen) == {(cfg.cap.max_kfs, cfg.cap.max_mps)}
    assert int(merged.n_kf) == sum(int(m.kf_valid.sum()) for m in maps)
    assert info["mps_fused"] >= 1 and bool(torch.isfinite(merged.kf_pose).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K,M", [(64, 512), (256, 2048), (64, 1024), (16, 257)])
def test_schur_kernel_at_mesh_block_shapes(card, K, M):
    """K3 at the per-block shapes the mesh path launches (a point block of
    (K, ⌈M/n⌉), odd ones too: ``partition_points`` pads M to n·⌈M/n⌉):
    within 1e-5 of the f64 plain version, the same bits twice."""
    Hpx, Hxx_inv = (a.to(card) for a in _schur_inputs(K, M, seed=2))
    got = K3.point_reduction(Hpx, Hxx_inv)
    again = K3.point_reduction(Hpx, Hxx_inv)
    want = K3.point_reduction_plain(Hpx.double(), Hxx_inv.double())
    torch.cuda.synchronize()
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_mesh_of_four_blocks_on_one_card_matches_one_block(card):
    """``sharded_solve_local_ba`` on ``make_mesh(4, device="cuda")``: one K3
    launch per block per LM step, at (K, M/4), and the solution within the
    JAX tests' tolerances of the 1-block solve (poses 5e-4, points 2e-3)."""
    from se2lam_tpu_torch.parallel import make_mesh, sharded_solve_local_ba

    cfg, _ = default_cfg()
    c = tracking.constants(cfg, card)
    K, M, P, iters = 16, 512, 6, 6
    prob, _ = ba.synthetic_grid_ba(np.random.default_rng(4), K, M, P, c["cam"], c["Tcb"])
    ba_cfg = ba.BAConfig(iters=iters)
    out, seen = {}, []
    orig = ba.schur_reduce

    def spy(Hpp, bp, Hpx, Hxx_inv, bx):
        seen.append((Hpx.shape[0], Hpx.shape[2], Hpx.device.type))
        return orig(Hpp, bp, Hpx, Hxx_inv, bx)

    ba.schur_reduce = spy
    try:
        for n in (1, 4):
            before = K3.point_reduction.launches
            out[n] = sharded_solve_local_ba(prob, c["cam"], c["Tcb"], ba_cfg,
                                            make_mesh(n, device="cuda"))
            torch.cuda.synchronize()
            assert K3.point_reduction.launches == before + n * iters
    finally:
        ba.schur_reduce = orig
    assert set(seen) == {(K, M, "cuda"), (K, M // 4, "cuda")}
    (p1, x1, i1), (p4, x4, i4) = out[1], out[4]
    assert float(i4["chi2"]) < 1e-3 * float(i4["chi2_init"])
    torch.testing.assert_close(p4, p1, rtol=0, atol=5e-4)
    torch.testing.assert_close(x4, x1, rtol=0, atol=2e-3)


@pytest.mark.cuda
def test_magnitude_measure_catches_a_dropped_point(card):
    """``chip_smoke.schur_readings`` on a cancelling real system (the dry
    run's damped local BA, K 64, M 2048, P 8: S ~4,000 times smaller than
    its products' magnitude sum): K3 within the bound, while the kernel's
    result on the system without its largest point reads over it, as the
    control predicts."""
    import chip_smoke as cs

    c = tracking.constants(default_cfg()[0], card)
    prob, _ = ba.synthetic_grid_ba(np.random.default_rng(0), 64, 2048, 8, c["cam"], c["Tcb"])
    cfg = ba.BAConfig(iters=3)
    _, _, Hpx, Hxx_inv, _, _ = ba.damped_system(prob, c["cam"], c["Tcb"], cfg,
                                                torch.tensor(cfg.lm_init_lambda, device=card))
    out = cs.schur_readings(Hpx, Hxx_inv)
    assert cs.schur_readings_ok(out) and out["cancellation"] > 100, out
    dropped = Hpx.clone()
    dropped[:, :, out["control_point"]] = 0.0
    want = K3.point_reduction_plain(Hpx.double(), Hxx_inv.double())
    err = float((K3.point_reduction(dropped, Hxx_inv).double() - want).abs().max())
    assert err / out["magnitude_scale"] > cs.SCHUR_CONTROL_MIN * cs.SCHUR_ABS_REL_MAX
    # an empty system reduces to exact zeros, which the measure accepts
    zero = cs.schur_readings(torch.zeros_like(Hpx), Hxx_inv)
    assert zero["magnitude_scale"] == 0 and cs.schur_readings_ok(zero)


@pytest.mark.cuda
def test_harris_extraction_on_card_matches_cpu(card):
    """``use_harris`` on the card: every output but ``response`` bitwise
    the card's output without it, one K1 launch a frame, ``response``
    within 1e-6 of max|R| from the CPU's on the same slots (read ~1e-7
    by ``chip_smoke.py`` on an H100)."""
    cfg, oc = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    img = torch.from_numpy(world.render(world.circle_trajectory(352, radius=2.5)[5]))
    harris = oc._replace(use_harris=True)
    before = K1.fast_nms.launches
    fg = OrbExtractor(harris, device=card)(img.to(card))
    torch.cuda.synchronize()
    assert K1.fast_nms.launches == before + 1
    off = OrbExtractor(oc, device=card)(img.to(card))
    for name in fg._fields:
        if name != "response":
            assert torch.equal(getattr(fg, name), getattr(off, name)), name
    fc = OrbExtractor(harris, device="cpu")(img)
    v = fc.valid
    assert torch.equal(fg.valid.cpu(), v)
    scale = float(fc.response[v].abs().max())
    assert 0 < scale < 1e-3
    torch.testing.assert_close(fg.response.cpu()[v], fc.response[v], rtol=0, atol=1e-6 * scale)


@pytest.mark.cuda
def test_remove_outlier_obs_on_card_matches_cpu(card, small_map):
    """``localmap.remove_outlier_obs`` on the card, on a real map and with
    one point moved 5 m: every table and ``n_bad`` bitwise the CPU's."""
    from se2lam_tpu_torch import localmap
    from se2lam_tpu_torch.mapstate import MapState

    cfg, slam = small_map
    ms = slam.ms
    cur = int(torch.nonzero(ms.kf_valid).max())
    victim = int(torch.nonzero(ms.mp_valid)[0])
    bad = ms._replace(mp_pos=ms.mp_pos.index_add(
        0, torch.tensor([victim]), torch.tensor([[5.0, 5.0, 3.0]])))
    for m in (ms, bad):
        want, n_want = localmap.remove_outlier_obs(m, cur, cfg)
        got, n_got = localmap.remove_outlier_obs(MapState(*(t.to(card) for t in m)), cur, cfg)
        assert int(n_got) == int(n_want)
        for name in ("kf_obs_mp", "mp_obs_kf", "mp_obs_feat", "mp_n_obs", "mp_valid"):
            assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
def test_mini_ba_constraint_on_card_runs_the_kernel(card, small_map):
    """``loopclose.build_loop_constraint_ba`` on the card between the map's
    last two keyframes: 10 Schur launches at (2, N), a symmetric
    information, and the constraint within the CPU's (pairs gated alike to
    within 2, the pose within 1e-3, the information within 5e-2 of its
    largest entry; on the loop scene ``chip_smoke.py`` reads 0 pairs,
    3.05e-4 and 6.95e-4)."""
    from se2lam_tpu_torch import loopclose
    from se2lam_tpu_torch.mapstate import MapState

    cfg, slam = small_map
    ms = slam.ms
    kfs = torch.nonzero(ms.kf_valid)[:, 0]
    k, cand = int(kfs[-1]), int(kfs[-2])
    midx, n_kp, _, _ = loopclose.verify_loop(ms, k, cand, 64,
                                            generator=torch.Generator().manual_seed(0))
    assert int(n_kp) >= 20
    want = loopclose.build_loop_constraint_ba(ms, k, cand, midx, cfg)
    gms = MapState(*(t.to(card) for t in ms))
    shapes = []
    orig = ba.schur_reduce

    def spy(Hpp, bp, Hpx, Hxx_inv, bx):
        shapes.append((Hpx.shape[0], Hpx.shape[2]))
        return orig(Hpp, bp, Hpx, Hxx_inv, bx)

    before = K3.point_reduction.launches
    ba.schur_reduce = spy
    try:
        meas, info, n_good, _ = loopclose.build_loop_constraint_ba(gms, k, cand, midx.to(card),
                                                                   cfg)
    finally:
        ba.schur_reduce = orig
    torch.cuda.synchronize()
    assert K3.point_reduction.launches == before + 10 and shapes == [(2, ms.N)] * 10
    assert abs(int(n_good) - int(want[2])) <= 2
    torch.testing.assert_close(meas.cpu(), want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(info.cpu(), want[1], rtol=0,
                               atol=5e-2 * float(want[1].abs().max()))
    assert torch.equal(info, info.T)


@pytest.mark.cuda
def test_solvers_repeat_bitwise_on_card(card, small_map):
    """F7: local BA, the joint GBA (point axis as a flat list, not the
    grid) and the dense pose graph give the same bits on every run on the
    card, outside deterministic mode: their float scatter-adds go through
    ``ops/fixed_order.index_add``."""
    from se2lam_tpu_torch import localmap, loopclose
    from se2lam_tpu_torch.mapstate import MapState
    from se2lam_tpu_torch.solver.posegraph import solve_pose_graph, synthetic_pose_graph

    assert not torch.are_deterministic_algorithms_enabled()
    cfg, slam = small_map
    ms = MapState(*(t.to(card) for t in slam.ms))
    kf = int(ms.n_kf) - 1
    c = tracking.constants(cfg, card)
    prob = loopclose._joint_problem(ms, cfg)
    flat = loopclose._joint_ba_cfg(ms, cfg, 3, grid=False)
    pg = synthetic_pose_graph(np.random.default_rng(0), 64, loop_pairs=[(0, 50), (5, 60)],
                              device=card)
    solves = [lambda: localmap.run_local_ba(ms, kf, cfg)[0][:2],
              lambda: ba.solve_local_ba(prob, c["cam"], c["Tcb"], flat)[:2],
              lambda: solve_pose_graph(pg, iters=10)[:1]]
    for solve in solves:
        first, again = solve(), solve()
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_segment_sum_on_card_matches_index_add(card):
    """``fixed_order.segment_sum`` on the card: within f32 rounding of the
    CPU's ``index_add_``, the same bits twice, the sort made once."""
    from se2lam_tpu_torch.ops import fixed_order

    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 300, (8192,), generator=g, dtype=torch.int32)
    vals = torch.randn(8192, 3, 3, generator=g)
    want = torch.zeros(300, 3, 3).index_add_(0, idx, vals)
    idx_c, vals_c = idx.to(card), vals.to(card)
    a = fixed_order.segment_sum(idx_c, vals_c, 300)
    b = fixed_order.index_add(torch.zeros(300, 3, 3, device=card), idx_c, vals_c)
    assert torch.equal(a, b) and len(fixed_order._SEGMENTS) >= 1
    torch.testing.assert_close(a.cpu(), want, rtol=0, atol=1e-5)
