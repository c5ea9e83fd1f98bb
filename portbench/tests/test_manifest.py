"""BENCHMARK.json against the contract's rules, and every file it names."""
import json
import re
from pathlib import Path

import pytest

from portbench.bench import Manifest
from portbench.traffic import load_traffic

ROOT = Path(__file__).resolve().parents[2]
MAN = Manifest(ROOT)
DOC = MAN.doc
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert DOC["command"] == ["python3", "portbench/run.py"]
    for p in DOC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (ROOT / p).is_dir()
        assert not p.endswith("_torch")


def test_names_and_units_use_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in DOC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in DOC["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\t" not in m["layer"]


def test_bounds_and_sources():
    names = {m["name"] for m in DOC["end_to_end"]}
    assert "setup_s" in names
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_moved_metric_is_reported_by_each_of_its_cells(cell):
    e2e = {m["name"] for m in MAN.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = MAN.per_layer(cell)
    assert per
    for m in per:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files_by_name(cell):
    w = MAN.cell(cell)
    doc = MAN.config(w["config"])
    assert (ROOT / "portbench" / "systems" / f"{doc['driver']}.py").is_file()
    load_traffic(MAN.traffic_path(w["traffic"]))
    limits = MAN.check_limits(cell)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    for m in MAN.per_layer(cell):
        assert callable(MAN.reader(m["name"]).read)


@pytest.mark.parametrize("cfg", [c["name"] for c in DOC["configs"]])
def test_configuration_files(cfg):
    c = next(c for c in DOC["configs"] if c["name"] == cfg)
    assert c["file"].startswith("portbench/") and 1 <= len(c["source"]) <= 200
    doc = json.loads((ROOT / c["file"]).read_text())
    assert doc["reduced"] == c["reduced"] == []
    assert doc["source"] == c["source"]
    assert any(w["config"] == cfg for w in DOC["workloads"])
