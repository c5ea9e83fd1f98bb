"""One run of one cell: set-up, the measured window, the traced readings,
the check against the plain references, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file found by its name in ``BENCHMARK.json``:

- ``configs[i].file``: the configuration (its ``driver`` names a module
  of ``portbench/systems/``);
- ``portbench/traffic/<traffic>.json``: the mix, read by ``traffic.py``;
- ``portbench/metrics/<metric>.py``: a reader, with the spans and holds
  it needs (``SPANS``, ``HOLDS``) and ``read(run)``, which returns the
  value or None when it finds nothing to read;
- ``portbench/checks/<cell>.json``: the limits of the cell's compared
  numbers.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "se2lam_tpu")
# a traced run records the device over the window's last this many seconds:
# the trace of an eager program holds tens of thousands of operations a
# second, and reading it costs about 40 µs an operation
TRACE_SECONDS = 15.0

__all__ = ["Manifest", "run_cell", "forbidden_modules"]


class Manifest:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench_dir = self.root / self.doc["paths"][0]

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"portbench: no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"portbench: no configuration named {name!r}")

    def traffic_path(self, name: str) -> Path:
        return self.bench_dir / "traffic" / f"{name}.json"

    def metric_path(self, name: str) -> Path:
        return self.bench_dir / "metrics" / f"{name}.py"

    def check_limits(self, cell: str) -> dict:
        return json.loads((self.bench_dir / "checks" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.doc["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        return [m for m in self.doc["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}",
            self.metric_path(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def session_class(self, driver: str):
        mod = importlib.import_module(f"portbench.systems.{driver}")
        return getattr(mod, mod.__all__[0])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``se2lam_tpu_torch`` is not ``se2lam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def quantile(xs, q):
    return float(np.quantile(np.asarray(xs, np.float64), q)) if xs else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, manifest: Manifest | None = None,
             config_override=None, max_frames: int | None = None,
             control: bool = False) -> dict:
    """The result of one run (the contract's last line, as a dict).
    ``config_override``: a function of the configuration file's dict that
    returns the one to run (tests run small sizes on the CPU with it);
    ``max_frames``: a cap on the window's frames (tests); ``control``: also
    read the control, the references in the precision below, into
    ``result["control"]``, and the trajectory numbers of a system whose
    state never moves from its first pose into ``result["state_unchanged"]``
    (``control.py``)."""
    import torch

    from .spans import Hold, Span
    from .traffic import load_traffic

    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest or Manifest()
    cell = man.cell(name)
    doc = man.config(cell["config"])
    if config_override is not None:
        doc = config_override(doc)
    traffic = load_traffic(man.traffic_path(cell["traffic"]))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    if on_card:
        from se2lam_tpu_torch.kernels import build_all
        build_all()
    session = man.session_class(doc["driver"])(doc, traffic, seed, seconds, device)
    sync()

    # the readers of this cell's per-layer metrics, and what they need
    readers = {m["name"]: man.reader(m["name"]) for m in man.per_layer(name)} if trace else {}
    span_targets = {}
    hold_targets = {}
    for r in readers.values():
        span_targets.update(getattr(r, "SPANS", {}))
        hold_targets.update(getattr(r, "HOLDS", {}))
    patches = []
    n_avail = len(session.seq.img_idx) if max_frames is None else min(
        max_frames, len(session.seq.img_idx))
    check_holds = {k: Hold(t, keep) for k, (t, keep) in session.holds(n_avail).items()}
    # the extractor's outputs of frames drawn from the seed, for the check
    extracted = []
    extract = Hold("se2lam_tpu_torch.frontend.orb:OrbExtractor.forward",
                   keep=session.extract_draw(n_avail))
    patches += list(check_holds.values()) + [extract]
    spans = {k: Span(k, t, device_events=on_card) for k, t in span_targets.items()}
    patches += list(spans.values())
    # the readers' holds cover the traced part of the window, as the trace does
    holds = {k: Hold(t) for k, t in hold_targets.items()}
    host_spans = {"process": []}

    session.start()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    for p in patches:
        p.install()
    prof = None
    trace_from = None                       # the first traced frame
    poses, lat_ms, failed = [], [], 0
    first_error = None
    try:
        sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while i < n_avail and time.perf_counter() < deadline:
            if trace and trace_from is None and time.perf_counter() >= deadline - TRACE_SECONDS:
                trace_from = i
                for h in holds.values():
                    patches.append(h.install())
                if on_card:
                    from .trace import start_profiler
                    sync()
                    prof = start_profiler()
                t0_ns = time.time_ns()
            n_kept = len(extract.kept)
            for h in check_holds.values():
                h.tag = i
            h0 = time.time_ns()
            f0 = time.perf_counter()
            try:
                pose = session.process(i)
                if pose is not None and not np.isfinite(np.asarray(pose)).all():
                    failed += 1
                    pose = None
            except Exception:                     # a frame that raises is a failed frame
                failed += 1
                pose = None
                if first_error is None:
                    first_error = traceback.format_exc()
            lat_ms.append(1e3 * (time.perf_counter() - f0))
            host_spans["process"].append((h0, time.time_ns()))
            if len(extract.kept) > n_kept:
                extracted.append((i, extract.kept[-1][3]))
            poses.append(pose)
            i += 1
        sync()
        window_s = time.perf_counter() - t0
        t1_ns = time.time_ns()
        if trace_from is None:
            trace_from, t0_ns = i, t1_ns
    finally:
        if prof is not None:
            ts = time.perf_counter()
            prof.stop()
            log(f"profiler stop {time.perf_counter() - ts:.1f} s")
        for p in reversed(patches):
            p.remove()
    n_done = i
    extract.kept.clear()
    if first_error is not None:
        log("first failed frame:\n" + first_error)
    if n_done >= n_avail:
        log(f"the window used all {n_avail} frames made for it")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    run = SimpleNamespace(
        cell=name, session=session, frames=n_done, traced_frames=n_done - (trace_from or 0),
        window_s=window_s, latencies_ms=lat_ms,
        counts=session.counts(), config=doc, on_card=on_card,
        spans={k: (s.ms() if on_card else []) for k, s in spans.items()}, holds=holds,
        trace=None)
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                       count=1, memory_peak_bytes=int(memory_peak))
    result = dict(correct=False, attempted=n_done, failed=failed, metrics={},
                  device=device_info)
    if trace:
        if prof is not None:
            from .trace import DeviceTrace
            ts = time.perf_counter()
            run.trace = DeviceTrace(prof, t0_ns, t1_ns)
            log(f"trace read: {len(run.trace.ops)} device operations in "
                f"{time.perf_counter() - ts:.1f} s")
            del prof
            device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            labels = {k: s.host for k, s in spans.items()}
            labels.update(host_spans)
            result["breakdown"] = dict(device_ops=run.trace.top_ops(),
                                       idle_gaps=run.trace.idle_gaps(labels))
        for m in man.per_layer(name):
            v = readers[m["name"]].read(run)
            if v is not None:
                result["metrics"][m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        values = dict(frames_per_s=n_done / window_s, frame_ms_p50=quantile(lat_ms, 0.5),
                      frame_ms_p90=quantile(lat_ms, 0.9), setup_s=setup_s)
        for m in man.end_to_end(name):
            if values.get(m["name"]) is not None:
                result["metrics"][m["name"]] = dict(value=float(values[m["name"]]),
                                                    unit=m["unit"])
    log("counts: " + json.dumps(dict(run.counts, frames=n_done, window_s=window_s,
                                     setup_s=setup_s)))
    for h in holds.values():
        h.kept.clear()

    # the check: after the window, with its peak read and the system freed
    session.system = None
    if on_card:
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    readings = session.readings(n_done, poses, check_holds, extracted)
    limits = man.check_limits(name)
    checks = {}
    for k, lim in limits.items():
        v = readings.get(k, float("inf"))
        checks[k] = dict(value=v, limit=lim)
    result["correct"] = bool(
        n_done > 0 and failed == 0
        and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    if control:
        result["control"] = session.readings(n_done, poses, check_holds, extracted, tf32=True)
        result["state_unchanged"] = session.unchanged(n_done)
    log(f"check took {time.perf_counter() - tc:.1f} s")
    # a number with nothing to compare (no sample reached) prints as null
    result["checks"] = {k: dict(value=c["value"] if math.isfinite(c["value"]) else None,
                                limit=c["limit"]) for k, c in checks.items()}
    for k, c in checks.items():
        ok = math.isfinite(c["value"]) and c["value"] <= c["limit"]
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r}) {'ok' if ok else 'FAILED'}")
    return result
