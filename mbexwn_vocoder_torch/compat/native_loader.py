"""ctypes bindings for the native C++ segment loader (native/segment_loader.cc).

Counterpart of the JAX package's compat/native_loader.py.  The library is
the repository's `native/libsegment_loader.so`, loaded by path.  When that
file is missing, or does not load on this host, it is built from
`native/segment_loader.cc` with the flags of `native/Makefile` into this
package's `_build/` directory (gitignored); nothing is written under
`native/`.  `available()` says whether either worked; `load_error()` says
why not.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_REPO = Path(__file__).absolute().parent.parent.parent
NATIVE_DIR = _REPO / "native"
SO_PATH = NATIVE_DIR / "libsegment_loader.so"
SOURCE = NATIVE_DIR / "segment_loader.cc"
BUILD_DIR = _REPO / "mbexwn_vocoder_torch" / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _build() -> Path:
    """Compile the loader into BUILD_DIR (a temporary name, then renamed, so
    a concurrent loader never sees a half-written file); returns its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libsegment_loader.so"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _open(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.sl_create.restype = ctypes.c_void_p
    lib.sl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint,
    ]
    lib.sl_next_batch.restype = ctypes.c_int
    lib.sl_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.sl_total_samples.restype = ctypes.c_long
    lib.sl_total_samples.argtypes = [ctypes.c_void_p]
    lib.sl_n_files.restype = ctypes.c_int
    lib.sl_n_files.argtypes = [ctypes.c_void_p]
    lib.sl_destroy.restype = None
    lib.sl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    """The library, loaded once: the tracked shared object, else one built
    into BUILD_DIR; None (and `load_error()`) when neither works."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        reasons = []
        if SO_PATH.exists():
            try:
                _lib = _open(SO_PATH)
                return _lib
            except OSError as e:
                reasons.append(f"{SO_PATH} does not load ({e})")
        else:
            reasons.append(f"{SO_PATH} is missing")
        try:
            _lib = _open(_build())
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", "") or ""
            reasons.append(f"building it from {SOURCE} failed ({e}{': ' + detail.strip() if detail else ''})")
            _error = "; ".join(reasons)
        return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    _load()
    return _error


class NativeSegmentLoader:
    """Random float32 audio segments served by C++ worker threads.  With
    more than one worker the order in which their segments arrive is not
    fixed; each worker's own stream is (seed + 1 + its index)."""

    def __init__(self, paths: Sequence[str], segment_len: int, sample_rate: int,
                 n_workers: int = 2, queue_depth: int = 64, seed: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native segment loader unavailable: {_error}")
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._lib = lib
        self._h = lib.sl_create(arr, len(paths), segment_len, sample_rate, n_workers, queue_depth, seed)
        if not self._h:
            raise RuntimeError("native segment loader: no usable WAV files (check sample rate and format)")
        self.segment_len = segment_len

    @property
    def n_files(self) -> int:
        return self._lib.sl_n_files(self._h)

    @property
    def total_samples(self) -> int:
        return self._lib.sl_total_samples(self._h)

    def next_batch(self, batch: int) -> np.ndarray:
        out = np.empty((batch, self.segment_len), dtype=np.float32)
        rc = self._lib.sl_next_batch(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch)
        if rc != 0:
            raise RuntimeError("native segment loader stopped")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.sl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
