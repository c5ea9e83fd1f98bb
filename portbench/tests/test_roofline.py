"""The operations and bytes of K1, K2 and K3 against hand-worked shapes."""
import pytest
import torch

from portbench import roofline as R


def test_k1_work_per_pixel():
    ops, nbytes = R.k1_work([(2, 3), (1, 4)])
    assert (ops, nbytes) == (215 * 10, 16 * 10)
    # 640x480 at scale 1.2 over 5 levels, as the cells' K1 launches
    shapes = [(int(round(480 / 1.2 ** l)), int(round(640 / 1.2 ** l))) for l in range(5)]
    assert shapes == [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309)]
    ops, nbytes = R.k1_work(shapes)
    assert nbytes == 16 * 842_491
    assert R.least_seconds(f32_ops=ops, nbytes=nbytes) == pytest.approx(16 * 842_491 / 3.35e12)


def test_k2_work_and_gate():
    # 2 rows, 3 columns: row 0's window admits columns 0 and 1, row 1 none
    d1 = torch.ones((2, 256), dtype=torch.int8)
    xy = torch.tensor([[10.0, 10.0], [100.0, 100.0]])
    win = torch.tensor([5.0, 1.0])
    lo, hi = torch.zeros(2), torch.ones(2)
    v1 = torch.tensor([True, True])
    d2 = torch.ones((3, 256), dtype=torch.int8)
    xy2 = torch.tensor([[12.0, 9.0], [15.0, 15.0], [50.0, 50.0]])
    oct2 = torch.tensor([0, 1, 0], dtype=torch.int32)
    v2 = torch.tensor([True, True, True])
    args = (d1, xy, win, lo, hi, v1, d2, xy2, oct2, v2)
    assert R.k2_gated_pairs(*args) == 2
    f32, i8, nbytes = R.k2_work(2, 3, 2, 100)
    assert (f32, i8, nbytes) == (2 * 3 * 10, 2 * 512, 100 + 32)


def test_k3_counts_live_keyframes_and_points_only():
    Hpx = torch.zeros((4, 3, 10, 3))
    Hpx[0, :, 2] = 1.0
    Hpx[3, 1, 7, 0] = 2.0
    assert R.k3_live(Hpx) == (2, 2)
    # K = 2 live keyframes (R = 6), M = 2 live points: 2·M·(9R + 3R(R+1)/2)
    ops, nbytes = R.k3_work(2, 2)
    assert ops == 2 * 2 * (9 * 6 + 3 * 6 * 7 // 2)
    assert nbytes == 4 * (9 * 2 * 2 + 9 * 2 + 9 * 2 * 2)
    # every slot of (256, 8192) as chip_smoke.schur_bound counts it
    ops_all, _ = R.k3_work(256, 8192)
    assert R.least_seconds(f32_ops=ops_all) * 1e3 == pytest.approx(0.21832, rel=1e-4)
    assert R.k3_work(0, 0) == (0, 0)
