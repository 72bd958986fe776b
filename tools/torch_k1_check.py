#!/usr/bin/env python3
"""A short check of the port's K1 (the fused WaveNet layer kernel) on one
NVIDIA GPU, for the first chip run after a change to the kernel:

    python3 tools/torch_k1_check.py

Builds the kernels (prints registers and spills per instantiation), then
holds `wavenet_stack` against `wavenet_stack_plain` on random weights at
shapes that cover the edges (one tile, ragged tiles, batch > 1, a dilation
wider than the utterance, widths that are no multiple of 8, 64 or the chunk
width) in bf16 (rel-RMS <= 2e-2) and fp32 (<= 1e-5), and times the bf16
stack at the two widths and two row counts of a 512-frame synthesis.
chip_smoke.py stays the full proof on the registry's weights; this takes
half a minute.  Needs no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).absolute().parent.parent))

from mbexwn_vocoder_torch.ops import kernel_lib  # noqa: E402
from mbexwn_vocoder_torch.ops.precision import exact_fp32  # noqa: E402
from mbexwn_vocoder_torch.ops.wavenet_stack import (pack_stack_weights, wavenet_stack,  # noqa: E402
                                                     wavenet_stack_plain)

REGISTRY_DILS = (1, 2, 4, 8, 16, 32, 64, 1, 2, 4, 8, 16)
CASES = [(64, 1, 128, (1,)), (64, 1, 128, (1, 2)), (320, 1, 256, (1, 2, 4)), (8, 2, 100, (1, 2, 64, 128)),
         (68, 3, 257, (1, 16, 4)), (340, 2, 130, REGISTRY_DILS), (340, 1, 50, (64, 1)),
         (320, 1, 12800, REGISTRY_DILS), (340, 2, 12837, REGISTRY_DILS)]


def make_case(C, B, T, dils, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, T, C, generator=g) * 0.3).to(device, dtype)
    cond = (torch.randn(B, T, 2 * C, generator=g) * 0.2).to(device, dtype)
    scale = 1.0 / np.sqrt(3 * C)
    weights = []
    for i in range(len(dils)):
        out = C if i == len(dils) - 1 else 2 * C
        weights.append(tuple(t.to(device, dtype) for t in (
            torch.randn(2 * C, 3, C, generator=g) * scale, torch.randn(2 * C, generator=g) * 0.05,
            torch.randn(out, C, generator=g) * scale, torch.randn(out, generator=g) * 0.05)))
    return x, cond, weights


def cuda_time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_check: FAIL no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kernel_lib.library()
    print(f"build {kernel_lib.build_info.get('seconds', 0.0):.1f} s on {torch.cuda.get_device_name(0)}")
    for line in kernel_lib.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "warning" in line or line.startswith("=="):
            print("   ", line.strip())
    failed = 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        for C, B, T, dils in CASES:
            if dtype == torch.float32 and T > 1000:
                continue  # the fp32 FMA kernel is the reference mode: small shapes suffice
            x, cond, weights = make_case(C, B, T, dils, dtype, device)
            with exact_fp32():
                got = wavenet_stack(x, cond, weights, dils)
                torch.cuda.synchronize()
                ref = wavenet_stack_plain(x, cond, weights, dils)
            rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
            ok = bool(torch.isfinite(got).all()) and rel <= tol
            failed += not ok
            print(f"{'ok  ' if ok else 'FAIL'} {str(dtype)[6:]} C={C} B={B} T={T} layers={len(dils)}: rel-RMS {rel:.3e} "
                  f"(<= {tol:g}), max abs {float((got - ref).abs().max()):.3e}", flush=True)
    for C in (320, 340):
        total = 0.0
        for T in (12800, 25600):
            x, cond, weights = make_case(C, 1, T, REGISTRY_DILS, torch.bfloat16, device)
            packed = pack_stack_weights(weights)
            ms = cuda_time_ms(lambda: wavenet_stack(x, cond, packed, REGISTRY_DILS))
            flop = T * C * C * (16.0 * (len(REGISTRY_DILS) - 1) + 14.0)
            total += ms
            print(f"bf16 C={C} rows={T}: {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s)", flush=True)
        print(f"bf16 C={C}: K1 per 512-frame synthesis {total:.3f} ms")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
