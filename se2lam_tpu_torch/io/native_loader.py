"""ctypes bindings of the native (C++) dataset loader (port of
se2lam_tpu.io.native_loader).

The reference's feed path is C++ (test_vn's imread loop,
test/test_vn.cpp:43-55); here image decode and file IO run in a native
worker pool off the Python thread (``se2lam_tpu_torch/native/
se2lam_native.cpp``, the port's own copy of the JAX package's source), so
the host loop only pops finished uint8 frames while the device works.

The library is compiled with g++ at first use into
``<repo>/build/se2lam_tpu_torch/native/`` (rebuilt when the source is
newer), to a temporary name and then renamed, so a concurrent process
never loads a half-written file. Without a toolchain ``native_available()``
is False and ``DatasetRoom`` decodes with PIL instead. Nothing is built
when the module is imported.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["native_available", "NativePrefetcher", "NativeDecodeError", "decode_bmp",
           "LIB_PATH", "SOURCE"]

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "native" / "se2lam_native.cpp"
LIB_PATH = PKG.parent / "build" / "se2lam_tpu_torch" / "native" / "libse2lam_native.so"


class NativeDecodeError(RuntimeError):
    """One frame failed native decode (e.g. an RLE or 1-bit BMP the native
    decoder does not handle); carries the frame index so callers can decode
    that file with PIL and continue the stream."""

    def __init__(self, index: int):
        super().__init__(f"native BMP decode failed for frame {index}")
        self.index = index


_lock = threading.Lock()
_state = {"tried": False, "lib": None}


def _compile():
    """g++ the source into LIB_PATH; False when there is no toolchain or
    the build fails."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
                        str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        Path(tmp).unlink(missing_ok=True)
        return False


def _build_and_load():
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        if not SOURCE.exists():
            return None
        stale = (not LIB_PATH.exists()
                 or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime)
        if stale and not _compile():
            return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            return None
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int64
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                ctypes.c_int64]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        lib.dl_decode_bmp.restype = ctypes.c_int64
        lib.dl_decode_bmp.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
        _state["lib"] = lib
        return lib


def native_available() -> bool:
    return _build_and_load() is not None


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _frame(buf: np.ndarray, hw: int) -> np.ndarray:
    """The (h, w) frame a decode packed as ``h << 32 | w``, copied out."""
    h, w = int(hw >> 32), int(hw & 0xFFFFFFFF)
    return buf[: h * w].reshape(h, w).copy()


def decode_bmp(path: str, max_pixels: int = 1 << 24) -> np.ndarray | None:
    """Synchronous native BMP decode to uint8 grayscale, or None (no
    toolchain, or a file the decoder rejects). uint8 keeps the frame at one
    byte a pixel on its way to the device, where the extractor casts it."""
    lib = _build_and_load()
    if lib is None:
        return None
    buf = np.empty(max_pixels, np.uint8)
    hw = lib.dl_decode_bmp(str(path).encode(), _ptr(buf), buf.size)
    return None if hw <= 0 else _frame(buf, hw)


class NativePrefetcher:
    """Iterator over ``<dir>/<i>.bmp`` frames decoded by a native worker
    pool: frames arrive in order (uint8 grayscale), a bounded ring keeps
    ``ring_cap`` frames decoded ahead of the consumer. A frame the decoder
    rejects raises ``NativeDecodeError`` and the stream goes on."""

    def __init__(self, image_dir: str, start: int, count: int, threads: int = 2,
                 ring_cap: int = 8, max_pixels: int = 1 << 24):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self._h = lib.dl_open(str(image_dir).encode(), start, count, threads, ring_cap)
        self._buf = np.empty(max_pixels, np.uint8)
        self._closed = False
        self._next_index = start

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._closed:
            raise StopIteration
        hw = self._lib.dl_next(self._h, _ptr(self._buf), self._buf.size)
        if hw == -1:
            self.close()
            raise StopIteration
        idx = self._next_index
        self._next_index += 1
        if hw == 0:
            raise NativeDecodeError(idx)     # this frame failed; the ring goes on
        return _frame(self._buf, hw)

    def close(self):
        if not self._closed:
            self._lib.dl_close(self._h)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
