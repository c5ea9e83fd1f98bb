"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, under ``<repo>/build/se2lam_tpu_torch/<hash>/``
keyed by a hash of all sources and the flags, so an edited source builds
anew. All libraries that are not built yet compile at once, one nvcc
process per source. nvcc's output, with ptxas's report of each kernel's
registers, shared memory and spills (``-Xptxas -v``), is kept beside each
library as ``lib<name>.log``; ``ptxas_summary`` reads it. Nothing here runs
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build_all", "load_library", "ptxas_summary"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build" / "se2lam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("se2lam_tpu_torch: nvcc not found (PATH, CUDA_HOME, "
                       "/usr/local/cuda/bin) — the CUDA kernels cannot build")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, all in parallel;
    returns {name: library path}. Raises with nvcc's output on failure."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in _sources()}
    todo = [(src, libs[src.stem]) for src in _sources()
            if not libs[src.stem].is_file()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, lib, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}: nvcc exit {p.returncode}\n{out}")
        else:
            lib.with_suffix(".log").write_text(out)   # complete before the library appears
            os.replace(tmp, lib)  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("se2lam_tpu_torch kernel build failed:\n"
                           + "\n".join(errors))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build_all()[name]))
        return lib


def ptxas_summary(text: str) -> list[dict]:
    """Each kernel's entry in ptxas's ``-v`` report (nvcc's output): its
    (mangled) name, registers, static shared memory bytes and spill bytes.
    Dynamic shared memory is set at launch and is not in the report."""
    kernels, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(name=m.group(1), registers=None, smem_bytes=0,
                       spill_stores=0, spill_loads=0)
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return kernels
