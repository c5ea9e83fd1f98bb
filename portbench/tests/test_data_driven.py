"""A later change adds a traffic mix, a cell, a configuration or a metric
by adding files and entries: the harness finds them by name, with no
edit to its code."""
import json
import shutil
from pathlib import Path

import numpy as np

from portbench.bench import Manifest
from portbench.traffic import load_traffic, make_sequence

ROOT = Path(__file__).resolve().parents[2]


def test_a_mix_and_a_metric_added_as_files_are_listed(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "portbench" / "traffic" / "dummy.json").write_text(json.dumps(dict(
        lap_frames=36, radius=2.0, odo_noise=[0.001, 0.001, 0.001], max_frames_per_s=4)))
    (tmp_path / "portbench" / "checks" / "room640_loc.dummy.json").write_text(
        json.dumps({"extract_diff": 0.0}))
    (tmp_path / "portbench" / "metrics" / "dummy_ms.py").write_text(
        "SPANS = {'dummy': 'se2lam_tpu_torch.localizer:_localize_step'}\n"
        "def read(run):\n    return None\n")
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["workloads"].append(dict(name="room640_loc.dummy", config="room640_loc",
                                 traffic="dummy", chips=1, why="a test mix"))
    doc["per_layer"].append(dict(name="dummy_ms", unit="ms", better="lower",
                                 source="program_span", layer="localizer tracked step",
                                 moves="frame_ms_p50", workloads=["room640_loc.dummy"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    man = Manifest(tmp_path)
    cell = man.cell("room640_loc.dummy")
    tr = load_traffic(man.traffic_path(cell["traffic"]))
    seq = make_sequence(tr, 10.0, np.random.default_rng(0))
    assert tr.lap_frames == 36 and len(seq.img_idx) == 40 and seq.lap.shape == (36, 3)
    assert [m["name"] for m in man.per_layer("room640_loc.dummy")] == ["dummy_ms"]
    assert man.reader("dummy_ms").SPANS == {"dummy": "se2lam_tpu_torch.localizer:_localize_step"}
    assert man.check_limits("room640_loc.dummy") == {"extract_diff": 0.0}
    assert man.session_class(man.config(cell["config"])["driver"]).__name__ == "LocalizerSession"
