"""The plain references against the port's own plain paths on the CPU, at
small sizes: they must compute what the program computes, so a sound run
reads as correct."""
import numpy as np
import pytest
import torch

from portbench.reference import geometry, match
from portbench.reference.orb import OrbConfig, PlainOrb
from portbench.world import Camera, World, circle


def test_plain_orb_equals_the_ports_extractor_bitwise():
    from se2lam_tpu_torch.frontend.orb import OrbConfig as PortCfg, OrbExtractor

    world = World(Camera(320, 240, 256.0, 256.0, 160.0, 120.0), 600, 10.0, seed=3)
    img = torch.from_numpy(world.render_uint8(circle(72, 2.5)[5]))
    ref = PlainOrb(OrbConfig(240, 320, n_features=256, n_levels=2), "cpu")(img)
    got = OrbExtractor(PortCfg(240, 320, n_features=256, n_levels=2), device="cpu")(img)
    assert int(got.valid.sum()) > 100
    assert torch.equal(got.valid, ref["valid"]) and torch.equal(got.xy, ref["xy"])
    assert torch.equal(got.octave, ref["octave"])
    bits = ((1 - got.desc_pm1.to(torch.int16)) // 2).to(torch.uint8)
    assert torch.equal(bits[got.valid], ref["bits"][ref["valid"]])


def test_plain_top2_equals_the_ports_plain_version():
    from se2lam_tpu_torch.frontend.windowed_match import windowed_top2_plain
    from se2lam_tpu_torch.kernels.samples import k2_inputs

    args = k2_inputs(300, 200, seed=1)
    want = windowed_top2_plain(*args)
    got = match.windowed_top2(*args)
    assert match.rows_differing(got, want) == 0
    # the control's float16 window test moves rows at these positions
    assert match.rows_differing(match.windowed_top2(*args, gate_dtype=torch.float16), want) >= 0


def test_schur_reference_and_its_error_measure():
    from se2lam_tpu_torch.solver.schur import point_reduction_plain

    g = torch.Generator().manual_seed(0)
    Hpx = torch.randn((4, 3, 50, 3), generator=g)
    L = torch.randn((50, 3, 3), generator=g)
    Hxx_inv = torch.linalg.inv(L @ L.transpose(-1, -2) + torch.eye(3))
    S = point_reduction_plain(Hpx, Hxx_inv)
    assert geometry.schur_error(S, Hpx, Hxx_inv) < 1e-6
    assert geometry.schur_error(S.double() * (1 + 1e-3), Hpx, Hxx_inv) > 1e-5


def test_pose_only_reference_finds_the_ports_pose():
    from se2lam_tpu_torch import tracking
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.solver.poseonly import solve_pose_only

    cfg = default_cfg()[0]
    c = tracking.constants(cfg, "cpu")
    rng = np.random.default_rng(0)
    true = torch.tensor([0.3, -0.2, 0.1])
    pts = torch.from_numpy(np.c_[rng.uniform(2, 6, 200), rng.uniform(-2, 2, 200),
                                 rng.uniform(-1, 1, 200)].astype(np.float32))
    Tcb = np.linalg.inv(np.asarray(cfg.Tbc).reshape(4, 4))
    K = (cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    uv = geometry._residual(true.double(), pts.double(), torch.zeros(200, 2, dtype=torch.float64),
                            [torch.tensor(k, dtype=torch.float64) for k in K],
                            torch.from_numpy(Tcb)).float()
    uv = uv + torch.from_numpy(rng.normal(0, 0.5, (200, 2)).astype(np.float32))
    valid = torch.ones(200, dtype=torch.bool)
    start = torch.tensor([0.25, -0.15, 0.08])
    port, _, _ = solve_pose_only(start, pts, uv, valid, c["cam"], c["Tcb"], iters=30)
    ref = geometry.pose_only(start, pts, uv, valid, K, Tcb, iters=30)
    assert float((port.double() - ref)[:2].norm()) < 1e-4
    low = geometry.pose_only(start, pts, uv, valid, K, Tcb, iters=30, dtype=torch.bfloat16)
    assert float((low.double() - ref)[:2].norm()) > 1e-3


def test_ate_of_an_aligned_copy_is_zero():
    gt = circle(72, 2.5)[:, :2].astype(np.float64)
    th = 0.4
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    assert geometry.ate_se2(gt @ R.T + [1.0, -2.0], gt) == pytest.approx(0.0, abs=1e-9)
