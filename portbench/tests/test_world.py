"""The frozen room renders the port's frames bitwise, and the traffic
generator gives every seed the same work."""
import numpy as np
import pytest

from portbench.traffic import Traffic, make_sequence
from portbench.world import Camera, World, circle, map_gauge, se2_minus, se2_plus


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_frozen_world_renders_the_ports_frames_bitwise(seed):
    from se2lam_tpu_torch.entry import default_cfg
    from se2lam_tpu_torch.io.synthetic import SyntheticWorld
    from se2lam_tpu_torch.io.synthetic import map_gauge as port_gauge

    cfg = default_cfg()[0]
    port = SyntheticWorld(cfg, n_landmarks=1200, room=10.0, seed=seed)
    mine = World(Camera(cfg.width, cfg.height, cfg.fx, cfg.fy, cfg.cx, cfg.cy), 1200, 10.0, seed)
    lap = circle(72, 2.5)
    assert np.array_equal(lap, port.circle_trajectory(72, radius=2.5))
    for p in lap[[0, 17, 40]]:
        assert np.array_equal(mine.render(p), port.render(p))
    assert np.array_equal(map_gauge(lap, lap[0]), port_gauge(lap))


def test_se2_helpers_invert():
    a, b = np.array([1.0, 2.0, 0.3], np.float32), np.array([-0.5, 0.7, 2.9], np.float32)
    assert np.allclose(se2_plus(b, se2_minus(a, b)), a, atol=1e-6)


def test_sequences_share_their_work_across_seeds():
    tr = Traffic(lap_frames=72, radius=2.5, odo_noise=(0.004, 0.002, 0.002),
                 max_frames_per_s=10, jump_every=4, jump_frames=18, map_laps=1,
                 map_odo_noise=(0.004, 0.002, 0.002))
    a = make_sequence(tr, 5.0, np.random.default_rng(1))
    b = make_sequence(tr, 5.0, np.random.default_rng(2))
    assert np.array_equal(a.img_idx, b.img_idx) and len(a.img_idx) == 50
    assert not np.array_equal(a.odo, b.odo)
    # every 4th frame jumps a quarter lap ahead, unseen by the odometry
    assert list(a.img_idx[:6]) == [0, 1, 2, 3, 4 + 18, 23]
    steps = [se2_minus(a.odo[i + 1], a.odo[i]) for i in range(5)]
    assert all(abs(s[0] - steps[0][0]) < 0.05 for s in steps)
    assert a.map_gt.shape == (72, 3) and a.map_odo.shape == (72, 3)
