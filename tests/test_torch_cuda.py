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
from se2lam_tpu_torch.kernels.samples import k2_inputs
from se2lam_tpu_torch.solver import ba
from se2lam_tpu_torch.solver import schur as K3

BENCH_LEVELS = [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309)]


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
def test_kernel_rejects_what_it_does_not_take(card):
    with pytest.raises(ValueError):
        K1.fast_nms(torch.zeros((64, 64), dtype=torch.float64, device=card), 20.0, 7.0)
    with pytest.raises(ValueError):
        K1.fast_nms(torch.zeros((64, 128), device=card)[:, ::2], 20.0, 7.0)


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
                                 (256, 8192)])
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
def test_localizer_step_launches_k2_once(card):
    """One tracked Localizer frame on the card: one projection match, so
    exactly one K2 launch (and 5 of K1 for the extraction)."""
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
    assert K1.fast_nms.launches == k1 + 5
