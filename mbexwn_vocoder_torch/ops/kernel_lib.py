"""Build and load the hand-written CUDA kernels of `csrc/`.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, for `sm_90a`; the objects are linked into one shared library with
a plain C interface, loaded with ctypes.  The library's name carries a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is reused.  The build happens at first use, never at import, and writes
only under the package's `_build/` directory (listed in .gitignore).

Each wrapper that launches a kernel adds one to its entry in `launches`,
right where it launches (inside the CUDA implementation of its
`torch.library` op, so a program loaded from disk counts too), so a caller
can show that a path really ran the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).absolute().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launch counts per kernel, read and reset by callers such as chip_smoke.py
launches = {"wavenet_layer": 0, "oscillator": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # dtype (0 fp32, 1 bf16), x_in, cond, w_dil, b_dil, w_rs, b_rs, x_out, skip,
    # B, T, C, Cp, Ch, dilation, skip_only, causal, stream
    "mbexwn_wavenet_layer": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, n_layers, x_buf0, x_buf1, cond, per-layer pointer arrays w_dil, b_dil,
    # w_rs, b_rs, int arrays dilations and skip_only, weight tensor maps (host,
    # bf16 only), skip, B, T, C, Cp, Ch, per-layer cond, causal, stream
    "mbexwn_wavenet_stack": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # out (host, 2 x 128 bytes), w_dil, w_rs, C, Cp, rows of w_rs
    "mbexwn_wavenet_weight_maps": [_P, _P, _P, _I, _I, _I],
    # f0, tables, phase_offset (or null), out, phase out (or null), chunk scratch,
    # B, T, chunk size, n_wavetable, n_grid, fp32(1/sr), nominal_f0, min_tr,
    # max_tr, 1/log(grid_factor), stream
    "mbexwn_oscillate": [_P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _I, _F, _F, _F, _F, _F, _P],
    # grid_sync, blocks, stream: an empty launch, the floor K2 is timed against
    "mbexwn_floor_launch": [_I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link one shared library; return its path."""
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libmbexwn_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name} ==\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log_text = "\n".join(logs)
        (BUILD_DIR / "build.log").write_text(log_text)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log_text}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0, cached=False, log=log_text)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def no_backward(op, name: str) -> None:
    """Register the autograd of the custom op `op`, whose kernel has no
    backward pass (nor have the JAX package's Pallas kernels): with grad
    mode on and an input that requires grad, the call raises instead of
    cutting the autograd graph.  Without grad the op runs as it is."""
    message = (f"CUDA kernel {name} has no backward pass and an input requires grad; run it under "
               f"torch.no_grad()/torch.inference_mode(), or train through the differentiable route "
               f"(training.Trainer: the per-layer WaveNet and oscillate_plain)")

    def refuse(ctx, inputs, output):
        raise RuntimeError(message)

    def backward(ctx, *grads):
        raise RuntimeError(message)

    op.register_autograd(backward, setup_context=refuse)


def on_device(device: torch.device):
    """The context a launch runs in: `device` made current.  A kernel's
    per-device state (K1's shared-memory attribute, K2's count of resident
    blocks) and the C entries' default device are the current device's,
    which need not be the device of the tensors and the stream passed in."""
    return torch.cuda.device(device)


def check(err: int, name: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def launched(ret: int, name: str) -> int:
    """The count of launches a C entry point enqueued, which it returns; a
    negative value is its error: -(cudaError), or -(10000 + CUresult) from a
    tensor-map encode."""
    if ret < 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {-ret} "
                           f"({'CUresult ' + str(-ret - 10000) if ret <= -10000 else 'cudaError ' + str(-ret)})")
    return ret
