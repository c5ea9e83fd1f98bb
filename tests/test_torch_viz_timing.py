"""The port's visualization dumps, ``SlamSystem.enable_viz`` and the stage
timers.

``compose_debug_image`` and ``draw_frame_debug`` draw the same canvas as
the JAX package's, pixel for pixel, from the same inputs (the port's as
torch tensors); the matplotlib plots are written; ``enable_viz`` writes a
frame-debug image and a map plot every n keyframes and logs every local
BA; the timers time, report and synchronise, and ``measure_rtt`` runs on
the device it is given.
"""
import dataclasses
import os
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from se2lam_tpu import viz as jviz
from se2lam_tpu_torch import viz as tviz
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io import SyntheticWorld
from se2lam_tpu_torch.system import SlamSystem
from se2lam_tpu_torch.utils import timing

from test_mapmerge import _cfg

torch.set_num_threads(2)
H, W, N = 60, 80, 40


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    img = rng.uniform(-10, 265, (H, W)).astype(np.float32)
    ref_img = rng.integers(0, 256, (H, W)).astype(np.uint8)
    xy = rng.uniform(-5, [W + 5, H + 5], (N, 2)).astype(np.float32)
    valid = rng.random(N) > 0.2
    match = np.where(rng.random(N) > 0.4, rng.integers(0, N, N), -1).astype(np.int32)
    ref_xy = rng.uniform(-5, [W + 5, H + 5], (N, 2)).astype(np.float32)
    loop_xy = rng.uniform(0, [W, H], (N, 2)).astype(np.float32)
    loop_match = np.where(rng.random(N) > 0.5, rng.integers(0, N, N), -1).astype(np.int32)
    return img, ref_img, xy, valid, match, ref_xy, loop_xy, loop_match


def _feats(xy, valid, torch_=False):
    if torch_:
        return types.SimpleNamespace(xy=torch.from_numpy(xy), valid=torch.from_numpy(valid))
    return types.SimpleNamespace(xy=xy, valid=valid)


def _px(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("panes", ["all", "current_only"])
def test_compose_debug_image_matches_jax(tmp_path, inputs, panes):
    img, ref_img, xy, valid, match, ref_xy, loop_xy, loop_match = inputs
    kw = dict(match_idx=match, ref_img=ref_img, ref_xy=ref_xy, loop_xy=loop_xy,
              loop_match=loop_match, label="f12 kf3")
    if panes == "current_only":
        kw = {}
    jviz.compose_debug_image(str(tmp_path / "j.png"), img, _feats(xy, valid), **kw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tviz.compose_debug_image(str(tmp_path / "t.png"), torch.from_numpy(img),
                             _feats(xy, valid, torch_=True), **tkw)
    j, t = _px(tmp_path / "j.png"), _px(tmp_path / "t.png")
    assert t.shape == (2 * H, 2 * W, 3)
    np.testing.assert_array_equal(t, j)


def test_draw_frame_debug_matches_jax(tmp_path, inputs):
    img, _, xy, valid, match, ref_xy, _, _ = inputs
    jviz.draw_frame_debug(str(tmp_path / "j.png"), img, _feats(xy, valid), match, ref_xy)
    tviz.draw_frame_debug(str(tmp_path / "t.png"), torch.from_numpy(img),
                          _feats(xy, valid, torch_=True), torch.from_numpy(match),
                          torch.from_numpy(ref_xy))
    np.testing.assert_array_equal(_px(tmp_path / "t.png"), _px(tmp_path / "j.png"))


def _viz_run(out, feed):
    cfg = config_from_fields(dataclasses.asdict(_cfg()))
    world = SyntheticWorld(cfg, n_landmarks=400, room=10.0, seed=2)
    gt = np.asarray(world.circle_trajectory(80))[:20]
    imgs, odos = [world.render(g) for g in gt], np.asarray(gt, np.float32)
    slam = SlamSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    slam.enable_viz(str(out), every_n_kf=1)
    if feed == "process":
        for img, o in zip(imgs, odos):
            slam.process(img, o)
    else:
        for i in range(0, len(imgs), 8):
            slam.process_chunk(imgs[i:i + 8], odos[i:i + 8])
    return slam, out


@pytest.fixture(scope="module")
def slam_viz(tmp_path_factory):
    return _viz_run(tmp_path_factory.mktemp("viz"), "process")


def test_chunked_feed_writes_the_same_dumps(tmp_path, slam_viz):
    """``process_chunk`` dumps the keyframes ``process`` dumps, with the
    fired frame's own image in the frame pane."""
    _, out = slam_viz
    _, got = _viz_run(tmp_path, "process_chunk")
    assert sorted(os.listdir(got)) == sorted(os.listdir(out))
    for f in sorted(os.listdir(out)):
        if f.startswith("frame_"):
            np.testing.assert_array_equal(_px(got / f), _px(out / f))


def test_enable_viz_writes_the_dumps_and_the_ba_log(slam_viz):
    slam, out = slam_viz
    n_ins = slam.n_local_ba
    assert n_ins >= 2
    frames = sorted(f for f in os.listdir(out) if f.startswith("frame_"))
    maps = sorted(f for f in os.listdir(out) if f.startswith("map_"))
    # one pair per inserted keyframe (the first keyframe inserts nothing)
    assert len(frames) == len(maps) == n_ins
    kf_frames = slam.kf_frame_ids[1:]
    assert frames == [f"frame_{f:05d}.png" for f in kf_frames]
    assert _px(out / frames[0]).shape == (2 * slam.cfg.height, 2 * slam.cfg.width, 3)
    assert len(slam.ba_log) == n_ins and all(r["chi2"] <= r["chi2_init"] for r in slam.ba_log)


def test_plots_are_written(tmp_path, slam_viz):
    slam, _ = slam_viz
    tviz.plot_map(str(tmp_path / "map.png"), slam.ms, title="t")
    est = np.asarray([p for _, p in slam.trajectory])
    tviz.plot_trajectories(str(tmp_path / "traj.png"),
                           {"slam": torch.from_numpy(est[:, :2]), "other": est[:, :2] + 0.1})
    for f in ("map.png", "traj.png"):
        assert _px(tmp_path / f).size > 0


def test_work_timer_and_stage_timer():
    wt = timing.WorkTimer()
    time.sleep(0.01)
    assert wt.stop() >= 10.0 and wt.ms >= 10.0
    st = timing.StageTimer(block=True)
    with st.stage("sleep"):
        time.sleep(0.005)
    out = st.timed("mm", lambda a: (a @ a, {"b": [a + 1]}), torch.ones(8, 8))
    assert torch.equal(out[0], torch.full((8, 8), 8.0))
    st.timed("mm", torch.mm, torch.ones(2, 2), torch.ones(2, 2))
    assert len(st.samples["mm"]) == 2 and st.samples["sleep"][0] >= 5.0
    rep = st.report()
    assert "sleep" in rep and "mm" in rep and len(rep.splitlines()) == 3
    st.reset()
    assert not st.samples


def test_stage_timer_finds_the_output_devices():
    t = torch.zeros(2)
    assert timing._cuda_devices((t, [t, {"x": t}], 3), set()) == set()


def test_device_trace_writes_a_trace(tmp_path):
    with timing.device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_measure_rtt_on_the_given_device():
    rtt = timing.measure_rtt(device="cpu", reps=3)
    assert 0.0 < rtt < 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA requested"):
            timing.measure_rtt()
