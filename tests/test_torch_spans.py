"""The program's span recorder (``se2lam_tpu_torch/utils/timing.py``), the
spans the stages open, and the benchmark's readers of them.

- The recorder alone: parent and request ids nest, a span inside one of
  its own name nests like any other, the ring drops its oldest record and
  counts it, counts attach and ``report`` sums them, nothing is recorded
  while neither a
  profiler session nor ``timing.tracing()`` is on, and a span around a CPU
  op under ``torch.profiler`` holds that op's kineto start (the shared
  clock, and the profiler's switch).
- The stages: ``SlamSystem(cfg)`` with its defaults on the revisit lap of
  ``tests/test_torch_chunked_loops.py`` (a 48-frame lap plus 28 revisit
  frames, 320x240; tracking's generator seeded 1, with which the port
  closes a loop at frame 52) under ``timing.tracing()``, then a cold
  ``Localizer`` on that session's saved map, and a second one fed by the
  pipelined feed and then ``process``.
- Each of the readers in ``portbench/metrics/`` that reads the spans, on a
  stub run whose recorder holds records made by hand.
"""
import dataclasses
import importlib.util
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from se2lam_tpu.io import SyntheticWorld
from se2lam_tpu_torch.convert import config_from_fields
from se2lam_tpu_torch.io import load_map
from se2lam_tpu_torch.localizer import Localizer
from se2lam_tpu_torch.system import SlamSystem
from se2lam_tpu_torch.utils import timing

from test_chunked import _cfg

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_recorder():
    timing.RECORDER.reset()
    yield
    timing.RECORDER.reset()


# -- the recorder --

def test_parent_and_request_ids_nest():
    st = timing.StageTimer()
    with st.open("a") as a:
        with st.open("b") as b:
            with st.open("c") as c:
                pass
        with st.open("d") as d:
            pass
    with st.open("e") as e:
        pass
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (-1, a.id, b.id, a.id, -1)
    assert a.request == b.request == c.request == d.request == e.request - 1
    assert [r.name for r in st.records()] == ["a", "b", "c", "d", "e"]
    assert all(r.end_ns >= r.start_ns > 0 for r in st.records())
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns <= e.start_ns
    assert [r.id for r in st.records()] == [a.id, b.id, c.id, d.id, e.id]


def test_a_span_inside_one_of_its_name_nests():
    st = timing.StageTimer()
    with st.open("frame") as outer:
        with st.open("frame") as inner:
            inner.count("tracked", 1)
            with st.open("step") as step:
                pass
    assert [r.name for r in st.records()] == ["frame", "frame", "step"]
    assert inner.parent == outer.id and step.parent == inner.id
    assert outer.counts is None and inner.counts == {"tracked": 1}


def test_the_ring_drops_the_oldest_and_counts_it():
    st = timing.StageTimer(capacity=4)
    for i in range(6):
        with st.open(f"s{i}"):
            pass
    assert [r.name for r in st.ring] == ["s2", "s3", "s4", "s5"] and st.dropped == 2
    assert [r.id for r in st.ring] == [2, 3, 4, 5]
    st.reset()
    assert not st.ring and st.dropped == 0


def test_records_select_by_name_and_start():
    st = timing.StageTimer()
    for name in ("a", "b", "a"):
        with st.open(name):
            time.sleep(0.001)
    a0, b, a1 = st.records()
    assert st.records("a") == [a0, a1] and st.records(("a", "b")) == [a0, b, a1]
    assert st.records("a", t0=b.start_ns) == [a1]
    assert st.records(None, t1=b.start_ns) == [a0, b]
    with st.open("open"):
        assert st.records("open") == []          # only closed spans are read


def test_counts_attach_to_spans():
    with timing.tracing() as rec:
        with timing.span("stage") as s:
            s.count("ok", True)
            s.count("candidates", np.int64(3))
    (r,) = rec.records("stage")
    assert r.counts == {"ok": 1, "candidates": 3}
    assert all(type(v) is int for v in r.counts.values())


def test_nothing_is_recorded_when_off():
    assert not timing._tracing and not torch.autograd.profiler._is_profiler_enabled
    s = timing.span("stage")
    assert s is timing.span("other") is timing._OFF
    with s as inner:
        inner.count("ok", 1)
    assert not timing.RECORDER.ring
    with timing.tracing():
        with timing.span("stage"):
            pass
    with timing.span("stage"):
        pass
    assert len(timing.RECORDER.records("stage")) == 1


def test_a_profiler_session_records_spans_on_its_clock():
    """``profile.start()`` turns recording on, and a span around a CPU op
    holds the op's kineto start: the spans and the trace share a clock."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(128, 128)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert torch.autograd.profiler._is_profiler_enabled
        with timing.span("probe"):
            torch.mm(a, a)
    finally:
        prof.stop()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timing.span("probe") is timing._OFF
    (r,) = timing.RECORDER.records("probe")
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mm"]
    assert len(starts) == 1 and r.start_ns <= starts[0] <= r.end_ns


def test_report_tabulates_spans_and_their_self_time():
    st = timing.StageTimer()
    with st.open("outer"):
        time.sleep(0.004)
        with st.open("inner"):
            time.sleep(0.01)
    lines = st.report().splitlines()
    assert len(lines) == 3 and lines[0].split()[-3:] == ["self", "s", "counts"]
    rows = {ln.split()[0]: ln.split() for ln in lines[1:]}
    (outer,), (inner,) = st.records("outer"), st.records("inner")
    assert rows["inner"][1] == rows["outer"][1] == "1"
    assert float(rows["outer"][-1]) == pytest.approx((outer.ms - inner.ms) / 1e3, abs=0.006)
    assert float(rows["inner"][-1]) == pytest.approx(inner.ms / 1e3, abs=0.006)


def test_report_sums_each_spans_counts():
    st = timing.StageTimer()
    for ok, n in ((1, 2), (0, 3), (1, 1)):
        with st.open("reloc") as r:
            r.count("ok", ok)
            r.count("candidates", n)
    with st.open("extract"):
        pass
    rows = {ln.split()[0]: ln.split() for ln in st.report().splitlines()[1:]}
    assert rows["reloc"][1] == "3" and rows["reloc"][-2:] == ["ok=2", "candidates=6"]
    assert len(rows["extract"]) == 7                 # no counts, no column


# -- the stages --

def _tree(rec):
    """Counter of (span, parent span) over the recorder's records."""
    by_id = _by_id(rec)
    return Counter((r.name, by_id[r.parent].name if r.parent >= 0 else None)
                   for r in rec.records())


def _by_id(rec):
    return {r.id: r for r in rec.records()}


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    """The traced revisit lap, then a cold Localizer on its saved map."""
    cfg = _cfg().replace(gm_dcl_min_kfid_offset=8, gm_vcl_num_min_match_mp=5,
                         gm_vcl_num_min_match_kp=15)
    world = SyntheticWorld(cfg, n_landmarks=500, room=10.0, seed=4)
    lap = world.circle_trajectory(48)
    gt = np.concatenate([lap, lap[:28]])
    odo = world.odometry(gt, noise=(0.004, 0.002, 0.002), seed=3)
    pcfg = config_from_fields(dataclasses.asdict(cfg))
    timing.RECORDER.reset()
    slam = SlamSystem(pcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    with timing.tracing() as rec:
        for g, o in zip(gt, odo):
            slam.process(world.render(g), o)
    slam_recs = list(rec.ring)
    out = tmp_path_factory.mktemp("map")
    slam.save_map(str(out))
    ms, vocab, _ = load_map(str(out), device="cpu")
    rec.reset()
    with timing.tracing():
        loc = Localizer(pcfg, ms, vocab, device="cpu", generator=torch.Generator().manual_seed(2))
        for g, o in zip(gt[20:30], odo[20:30]):
            loc.process(world.render(g), o)
    loc_recs = list(rec.ring)
    mixed = Localizer(pcfg, ms, vocab, device="cpu", generator=torch.Generator().manual_seed(2))
    mixed.set_pose(loc.trajectory[-1][1], odo[29])
    mixed.pipeline_depth = 3
    rec.reset()
    with timing.tracing():
        for g, o in zip(gt[30:33], odo[30:33]):
            mixed.process_async(world.render(g), o)
        mixed.process(world.render(gt[33]), odo[33])
    mixed_recs = list(rec.ring)
    return slam, slam_recs, loc, loc_recs, mixed, mixed_recs


def _recorder(recs):
    st = timing.StageTimer()
    st.ring.extend(recs)
    return st


def test_every_frame_is_a_request_with_its_stages(slam_run):
    slam, recs, *_ = slam_run
    rec = _recorder(recs)
    frames = rec.records("slam.frame")
    assert len(frames) == slam.frame_id == 76
    assert all(r.parent == -1 for r in frames)
    assert len({r.request for r in frames}) == 76
    tree = _tree(rec)
    assert tree[("slam.extract", "slam.frame")] == 76
    assert tree[("slam.track", "slam.frame")] == 75          # the first frame bootstraps
    by_id = _by_id(rec)
    assert all(r.request == by_id[r.parent].request for r in rec.records() if r.parent >= 0)
    # keyframe is 1 on the frames that inserted one (the bootstrap's too)
    kf = [r.counts["keyframe"] for r in frames]
    assert sum(kf) == len(slam.kf_frame_ids)
    assert [i for i, k in enumerate(kf) if k] == slam.kf_frame_ids


def test_keyframes_insert_and_run_the_loop_stage(slam_run):
    slam, recs, *_ = slam_run
    rec = _recorder(recs)
    tree = _tree(rec)
    n_ins = slam.n_local_ba
    assert n_ins == len(slam.kf_frame_ids) - 1 >= 5
    for pair in (("slam.insert", "slam.frame"), ("map.local_ba", "slam.insert"),
                 ("slam.loop", "slam.frame"), ("loop.detect", "slam.loop"),
                 ("loop.verify", "loop.detect"), ("slam.reseed", "slam.frame")):
        assert tree[pair] == n_ins, pair
    assert tree[("loop.vocab", "slam.loop")] == slam._loop_closer.n_vocab_trainings >= 1
    # the spans under a frame hold nearly all of its time
    frame_ns = sum(r.end_ns - r.start_ns for r in rec.records("slam.frame"))
    frame_ids = {r.id for r in rec.records("slam.frame")}
    child_ns = sum(r.end_ns - r.start_ns for r in rec.records() if r.parent in frame_ids)
    assert child_ns >= 0.9 * frame_ns


def test_the_closure_runs_the_correction(slam_run):
    slam, recs, *_ = slam_run
    rec = _recorder(recs)
    lc = slam._loop_closer
    assert lc.n_loops_closed >= 1
    detect = rec.records("loop.detect")
    # verified counts the real candidates of the 5 slots, at least the
    # feature edges made and the loop fired; the empty slots (all of them on
    # the first keyframes, which have no partner yet) are not counted
    assert all(r.counts["feat_edges"] + r.counts["fired"] <= r.counts["verified"] <= 5
               for r in detect)
    assert detect[0].counts["verified"] == 0
    assert 1 <= sum(r.counts["verified"] for r in detect) < 5 * len(detect)
    assert sum(r.counts["fired"] for r in detect) == lc.n_loops_closed
    assert sum(r.counts["renewal"] for r in detect) == lc.n_renewal_gbas
    corrections = lc.n_loops_closed + lc.n_renewal_gbas
    tree = _tree(rec)
    assert tree[("loop.correct", "slam.loop")] == corrections
    assert tree[("loop.pose_graph", "loop.correct")] == corrections
    assert tree[("loop.merge", "loop.correct")] == lc.n_loops_closed
    assert tree[("loop.joint_ba", "loop.correct")] == lc.n_loops_closed
    by_id = _by_id(rec)
    for c in rec.records("loop.correct"):
        d = by_id[c.parent]
        assert d.name == "slam.loop"
        det = [r for r in detect if r.parent == d.id]
        assert len(det) == 1 and (det[0].counts["fired"] or det[0].counts["renewal"])
        assert det[0].end_ns <= c.start_ns


def test_the_localizer_builds_relocalizes_and_tracks(slam_run):
    _, _, loc, recs, *_ = slam_run
    rec = _recorder(recs)
    tree = _tree(rec)
    (build,) = rec.records("loc.build")
    assert build.parent == -1
    frames = rec.records("loc.frame")
    assert len(frames) == 10 and all(r.parent == -1 for r in frames)
    assert [r.counts["tracked"] for r in frames] == [int(t) for _, _, t in loc.trajectory]
    assert len({r.request for r in frames} | {build.request}) == 11
    assert tree[("loc.extract", "loc.frame")] == 10
    relocs = rec.records("loc.reloc")
    assert relocs and tree[("loc.reloc", "loc.frame")] == len(relocs)
    assert all(r.counts["candidates"] >= 1 for r in relocs)
    assert sum(r.counts["ok"] for r in relocs) >= 1
    assert tree[("loc.verify", "loc.reloc")] == sum(r.counts["candidates"] for r in relocs)
    assert tree[("loc.refine", "loc.reloc")] >= 1
    steps = rec.records("loc.step")
    assert len(steps) >= 5 and sum(r.counts["ok"] for r in steps) == sum(
        r.counts["tracked"] for r in frames)
    assert tree[("loc.match", "loc.step")] == tree[("loc.solve", "loc.step")] == len(steps)


def test_process_resolves_the_pipelined_frames_before_its_own(slam_run):
    """The frames still in flight resolve before ``process`` opens its
    frame: its ``loc.frame`` holds its own step alone, and its count is its
    own frame's."""
    *_, mixed, recs = slam_run
    rec = _recorder(recs)
    assert len(mixed.trajectory) == 4
    (frame,) = rec.records("loc.frame")
    assert frame.counts == {"tracked": int(mixed.trajectory[-1][2])}
    inside = [r for r in rec.records() if r.request == frame.request]
    assert Counter(r.name for r in inside if r.parent == frame.id) in (
        Counter({"loc.extract": 1, "loc.step": 1}), Counter({"loc.extract": 1, "loc.step": 1,
                                                             "loc.reloc": 1}))
    assert all(r.end_ns <= frame.start_ns for r in rec.records() if r.request != frame.request)


# -- the readers --

def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"_reader_{name}", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MS = 1_000_000
T0 = 10**18


def _stub_recorder():
    """Records by hand on a clock starting at T0; the window is
    [T0, T0 + 1000 ms]; a span at -50 ms lies outside it."""
    st = timing.StageTimer()
    ids = iter(range(10**6))

    def add(name, a_ms, b_ms, parent=None, **counts):
        r = timing.SpanRecord(next(ids), name, -1 if parent is None else parent.id, 0, [])
        r.start_ns, r.end_ns = T0 + a_ms * MS, T0 + b_ms * MS
        r.counts = counts or None
        st.ring.append(r)
        return r

    for a in (0, 500):
        loop = add("slam.loop", a, a + 100)
        add("loop.detect", a, a + (10 if a == 0 else 30), loop)
    add("loop.correct", 540, 548, loop)
    add("loop.detect", -50, -40)
    for a, m in ((100, 2), (200, 4), (300, 9)):
        step = add("loc.step", a, a + 20)
        add("loc.match", a, a + m, step)
        add("loc.solve", a + m, a + m + 3 * m, step)
    reloc = add("loc.reloc", 400, 450, candidates=1)
    add("loc.match", 420, 421, reloc)
    add("loc.solve", 421, 499, reloc)
    add("loc.reloc", 600, 650, candidates=3)
    add("loc.build", 700, 710)
    add("loc.build", 800, 820)
    add("loc.build", -50, -10)
    return st


def _stub_trace():
    ops = [("k", T0 + x * MS, 1000, True) for x in (1, 50, 99, 505, 700)]
    ops += [("Memcpy HtoD", T0 + 20 * MS, 1000, False)]
    return SimpleNamespace(t0=T0, t1=T0 + 1000 * MS, ops=ops)


@pytest.mark.parametrize("name,want", [
    ("loop_detect_ms_per_kf", 20.0),
    ("loop_correct_ms_per_kf", 4.0),
    ("loop_kernels_per_kf", 2.0),
    ("loc_match_ms", 4.0),
    ("loc_solve_ms", 12.0),
    ("localizer_build_ms", 15.0),
    ("reloc_candidates_per_call", 2.0),
])
def test_readers_of_the_spans(monkeypatch, name, want):
    r = _reader(name)
    monkeypatch.setattr(timing, "RECORDER", _stub_recorder())
    assert r.read(SimpleNamespace(trace=_stub_trace())) == pytest.approx(want)
    assert r.read(SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(timing, "RECORDER", timing.StageTimer())
    assert r.read(SimpleNamespace(trace=_stub_trace())) is None
    # a program without the recorder reads nothing and raises nothing
    monkeypatch.delattr(timing, "RECORDER")
    assert r.read(SimpleNamespace(trace=_stub_trace())) is None
