"""The port's command-line drivers, run as subprocesses on the CPU
(``--device cpu``) at small sizes: ``make_dataset`` renders a 40-frame
synthetic DatasetRoom (the drivers' synthetic configuration, 640x480, 500
features, 3 levels, a keyframe every 3-9 frames); ``run_dataset`` maps 24
of its frames from disk (loops off) and saves the map;
``run_localization`` localizes its first 16 frames on that map (the frames
the JAX package's Localizer localizes); ``merge_maps`` merges it with the
map of a second session over the route's first 16 frames; ``serve_live``
serves a small session fed by ``feed_live``; ``evaluate_ate`` scores the
localizer's trajectory.
Each driver's outputs are checked; the merged and the run's maps reload.
"""
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from se2lam_tpu_torch.drivers import evaluate_ate
from se2lam_tpu_torch.io import load_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _run(name, *args, timeout=300):
    out = subprocess.run([sys.executable, "-m", f"se2lam_tpu_torch.drivers.{name}", *args],
                         cwd=REPO, env=ENV, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers")
    out = {"root": d}
    out["make"] = _run("make_dataset", "--out", str(d / "room"), "--frames", "40")
    # the format carries the keyframe cadence as fps (fps // 3 to fps
    # frames); 9 gives a keyframe every 3-9 frames, as the JAX package's
    # tests/test_dataset_e2e.py sets it
    settings = d / "room" / "Settings.yml"
    settings.write_text(settings.read_text().replace("fps: 30\n", "fps: 9\n"))
    ds = str(d / "room" / "DatasetRoom")
    yml = ["--cam", str(d / "room" / "CamConfig.yml"), "--settings", str(settings)]
    out["slam"] = _run("run_dataset", ds, "--out", str(d / "slam"), "--frames", "24",
                       "--no-loops", "--device", "cpu")
    out["loc"] = _run("run_localization", str(d / "slam" / "map"), ds, "--out",
                      str(d / "loc"), "--frames", "16", "--device", "cpu")
    # robot B drove the first 16 frames of the same route: a second session
    out["slam_b"] = _run("run_dataset", ds, "--out", str(d / "slam_b"), "--frames", "16",
                         "--no-loops", "--device", "cpu")
    out["merge"] = _run("merge_maps", str(d / "slam" / "map"), str(d / "slam_b" / "map"),
                        "--out", str(d / "merged"), *yml, "--device", "cpu")
    return out


def test_make_dataset(runs):
    root = runs["root"] / "room"
    assert "wrote 40 frames" in runs["make"]
    assert sorted(os.listdir(root / "DatasetRoom" / "image"))[:2] == ["0.bmp", "1.bmp"]
    for f in ("CamConfig.yml", "Settings.yml", "DatasetRoom/odo_raw.txt", "DatasetRoom/gt.txt"):
        assert (root / f).is_file(), f


def test_run_dataset(runs):
    out, d = runs["slam"], runs["root"] / "slam"
    assert "24 frames in" in out and "ATE (SE2-aligned RMSE)" in out
    rows = np.loadtxt(d / "se2lam_kf_trajectory.txt", ndmin=2)
    ms, vocab, info = load_map(str(d / "map"), "cpu")
    assert rows.shape == (info["n_kf"], 5) and info["n_kf"] >= 3 and vocab is not None
    assert (d / "ate.json").is_file()
    assert (d / "trajectory.png").is_file() and (d / "map.png").is_file()


def test_run_localization(runs):
    """The driver's localized frames are those of the JAX package's
    Localizer on the same saved map and frames (a few: the map is sparse
    and the route turns fast)."""
    from se2lam_tpu.config import SystemConfig as JaxConfig
    from se2lam_tpu.io import DatasetRoom as JaxRoom
    from se2lam_tpu.io import load_map as jax_load_map
    from se2lam_tpu.localizer import Localizer as JaxLocalizer

    out, d = runs["loc"], runs["root"]
    rows = np.loadtxt(d / "loc" / "localizer_trajectory.csv", delimiter=",", ndmin=2)
    assert rows.shape == (16, 5)
    got = np.isfinite(rows[:, 1]).tolist()
    assert f"localized {sum(got)}/16" in out
    cfg = JaxConfig.from_yaml(str(d / "room" / "CamConfig.yml"), str(d / "room" / "Settings.yml"))
    ms, vocab, _ = jax_load_map(str(d / "slam" / "map"))
    loc = JaxLocalizer(cfg, ms, vocab)
    want = [loc.process(img, o) is not None
            for img, o in JaxRoom(str(d / "room" / "DatasetRoom"), count=16)]
    assert got == want and sum(got) >= 4


def test_merge_maps(runs):
    out, d = runs["merge"], runs["root"]
    assert "merged at pair" in out
    ms, vocab, info = load_map(str(d / "merged"), "cpu")
    n_a = load_map(str(d / "slam" / "map"), "cpu")[2]["n_kf"]
    n_b = load_map(str(d / "slam_b" / "map"), "cpu")[2]["n_kf"]
    assert info["n_kf"] == n_a + n_b and vocab is not None


def test_evaluate_ate(runs, tmp_path):
    d = runs["root"]
    gt = np.loadtxt(d / "room" / "DatasetRoom" / "gt.txt")
    ref = tmp_path / "gt_ids.txt"
    np.savetxt(ref, np.column_stack([np.arange(len(gt)), gt]))
    res = evaluate_ate.main([str(d / "loc" / "localizer_trajectory.csv"), str(ref)])
    assert res["n_associated"] >= 4 and res["ate_rmse"] < 0.5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_and_feed_live():
    port = str(_free_port())
    srv = subprocess.Popen(
        [sys.executable, "-m", "se2lam_tpu_torch.drivers.serve_live", "--port", port,
         "--width", "160", "--height", "120", "--features", "128", "--chunk", "4",
         "--device", "cpu"], cwd=REPO, env=ENV, stdout=subprocess.PIPE, text=True)
    try:
        assert "serving on" in srv.stdout.readline()
        out = _run("feed_live", "--synthetic", "--frames", "10", "--port", port,
                   "--width", "160", "--height", "120")
        assert "fed 10 frames" in out
    finally:
        srv.send_signal(signal.SIGINT)
        rest, _ = srv.communicate(timeout=60)
    assert "served 10 frames" in rest
