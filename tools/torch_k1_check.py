#!/usr/bin/env python3
"""A short check of the port's K1 (the fused WaveNet layer kernel) on one
NVIDIA GPU, for the first chip run after a change to the kernel:

    python3 tools/torch_k1_check.py [--root DIR] [--digest]

Builds the kernels (prints registers and spills per instantiation), then
holds `wavenet_stack` against `wavenet_stack_plain` on random weights at
shapes that cover the edges (one tile, ragged tiles, batch > 1, a dilation
wider than the utterance, widths that are no multiple of 8, 64 or the chunk
width) in bf16 (rel-RMS <= 2e-2) and fp32 (<= 1e-5), with one conditioning
slab shared by every layer and with a slab a layer (B, T, L, 2C) up to
WaveGlow's WN (C=256, 8 layers, dilations 2^i) at batch 1 and 8 of a
1024-frame bucket (32,768 rows an utterance); a per-layer cond whose slabs
are all equal gives the shared call's output bit for bit.  A shared cond at
the frame rate with the registry's upsampling factor (U = 25; SAME and
causal, up to the offline groups' blocks: batch 8 of a 1024-frame bucket)
gives the output of the same call on `linear_interp_upsample`'s full-rate
slab bit for bit.  Then it times the bf16 stack at the registry's two
widths and two row counts of a 512-frame synthesis, the offline groups'
blocks with the frame-rate cond against the full-rate slab (K1 alone, and
with the interpolation that makes the slab), and WaveGlow's WN at batch 1
and 512 frames.

`--digest` prints a SHA-256 of the shared-cond outputs at SPEECH's and
VOICE's shapes (bf16 and fp32; U = 1, then the frame-rate cases where the
package takes them), to hold two trees' kernels bit-equal; `--root DIR`
runs the package of another checkout (a parent's).
chip_smoke.py stays the full proof on the registry's weights; this takes
about a minute.  Needs no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import sys
from pathlib import Path

import numpy as np
import torch

REGISTRY_DILS = (1, 2, 4, 8, 16, 32, 64, 1, 2, 4, 8, 16)
WAVEGLOW_DILS = (1, 2, 4, 8, 16, 32, 64, 128)
CASES = [(64, 1, 128, (1,)), (64, 1, 128, (1, 2)), (320, 1, 256, (1, 2, 4)), (8, 2, 100, (1, 2, 64, 128)),
         (68, 3, 257, (1, 16, 4)), (340, 2, 130, REGISTRY_DILS), (340, 1, 50, (64, 1)),
         (320, 1, 12800, REGISTRY_DILS), (340, 2, 12837, REGISTRY_DILS)]
# (C, B, T, dilations) with a cond slab a layer: edges, then WaveGlow's WN at batch 1 and 8, bucket 1024
PER_LAYER_CASES = [(8, 2, 100, (1, 2, 64)), (68, 3, 257, (1, 16, 4)), (256, 1, 300, WAVEGLOW_DILS),
                   (256, 1, 32768, WAVEGLOW_DILS), (256, 8, 32768, WAVEGLOW_DILS)]
DIGEST_CASES = [(320, 1, 12800), (320, 1, 25600), (340, 1, 12800), (340, 2, 12837)]
U = 25  # the registry models' cond_lin_upsampling
# (C, B, frames, dilations, causal) with a frame-rate cond: rows = frames x U
UPSAMPLED_CASES = [(8, 2, 4, (1, 2, 64, 128), False), (68, 3, 11, (1, 16, 4), True), (256, 2, 37, (1, 2, 4), False),
                   (320, 1, 512, REGISTRY_DILS, False), (340, 2, 513, REGISTRY_DILS, True),
                   (320, 8, 1024, REGISTRY_DILS, False), (320, 8, 2048, REGISTRY_DILS, False),
                   (340, 8, 1024, REGISTRY_DILS, False), (340, 8, 2048, REGISTRY_DILS, False)]
# the offline groups' blocks: (C, B, frames) of block 0 (2 kHz) and block 1 (4 kHz)
OFFLINE_BLOCKS = [(320, 8, 1024), (320, 8, 2048), (340, 8, 1024), (340, 8, 2048)]


def make_case(C, B, T, dils, dtype, device, seed=0, per_layer=False):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, T, C, generator=g) * 0.3).to(device, dtype)
    shape = (B, T, len(dils), 2 * C) if per_layer else (B, T, 2 * C)
    cond = (torch.randn(*shape, generator=g) * 0.2).to(device, dtype)
    scale = 1.0 / np.sqrt(3 * C)
    weights = []
    for i in range(len(dils)):
        out = C if i == len(dils) - 1 else 2 * C
        weights.append(tuple(t.to(device, dtype) for t in (
            torch.randn(2 * C, 3, C, generator=g) * scale, torch.randn(2 * C, generator=g) * 0.05,
            torch.randn(out, C, generator=g) * scale, torch.randn(out, generator=g) * 0.05)))
    return x, cond, weights


def make_frames(C, B, frames, dtype, device, seed=0):
    """A frame-rate cond as the model hands K1 one: (B, frames + 1, 2C), the last frame repeated."""
    g = torch.Generator().manual_seed(seed + 1000)
    cond = (torch.randn(B, frames, 2 * C, generator=g) * 0.2).to(device, dtype)
    return torch.cat([cond, cond[:, -1:]], dim=1)


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


def rel_rms(got, ref):
    return float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))


def digests(ws, device) -> None:
    """SHA-256 of the shared-cond skip sums at the registry models' shapes."""
    for dtype in (torch.bfloat16, torch.float32):
        for C, B, T in DIGEST_CASES:
            if dtype == torch.float32 and T > 13000:
                continue
            x, cond, weights = make_case(C, B, T, REGISTRY_DILS, dtype, device, seed=7)
            with ws.exact_fp32():
                y = ws.wavenet_stack(x, cond, weights, REGISTRY_DILS)
            h = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
            print(f"digest {str(dtype)[6:]} C={C} B={B} T={T}: {h}", flush=True)
    if not ws.upsampled:
        print("digest: this package's K1 takes no frame-rate cond", flush=True)
        return
    for dtype in (torch.bfloat16, torch.float32):
        for C, B, frames, dils, causal in UPSAMPLED_CASES:
            if dtype == torch.float32 and B * frames * U > 30000:
                continue
            x, _, weights = make_case(C, B, frames * U, dils, dtype, device, seed=7)
            with ws.exact_fp32():
                y = ws.wavenet_stack(x, make_frames(C, B, frames, dtype, device, seed=7), weights, dils,
                                     causal=causal, cond_upsampling=U)
            h = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
            print(f"digest {str(dtype)[6:]} C={C} B={B} frames={frames} U={U}{' causal' if causal else ''}: {h}",
                  flush=True)


def check_upsampled(ws, device) -> int:
    """K1 on a frame-rate cond against K1 on the upsampler's slab (bit for bit) and the plain version."""
    failed = 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        for C, B, frames, dils, causal in UPSAMPLED_CASES:
            if dtype == torch.float32 and B * frames * U > 30000:
                continue
            x, _, weights = make_case(C, B, frames * U, dils, dtype, device)
            low = make_frames(C, B, frames, dtype, device)
            with ws.exact_fp32():
                got = ws.wavenet_stack(x, low, weights, dils, causal=causal, cond_upsampling=U)
                slab = ws.interp(low, U, drop_last=True)
                same = torch.equal(got, ws.wavenet_stack(x, slab, weights, dils, causal=causal))
                rel = rel_rms(got, ws.plain(x, low, weights, dils, causal=causal, cond_upsampling=U)) \
                    if B * frames <= 4096 else float("nan")
            ok = same and bool(torch.isfinite(got).all()) and not rel > tol
            failed += not ok
            print(f"{'ok  ' if ok else 'FAIL'} {str(dtype)[6:]} C={C} B={B} frames={frames} U={U} "
                  f"{'causal' if causal else 'SAME'}: {'bit-equal to' if same else 'DIFFERS from'} the "
                  f"full-rate slab's call; rel-RMS to plain {rel:.3e}", flush=True)
            del x, low, weights, got, slab
    return failed


def time_upsampled(ws, device) -> None:
    """Device ms a stack call at the offline groups' block shapes: K1 on the frame-rate cond, K1 on the
    full-rate slab, and the interpolation that makes the slab."""
    for C, B, frames in OFFLINE_BLOCKS:
        x, _, weights = make_case(C, B, frames * U, REGISTRY_DILS, torch.bfloat16, device)
        packed = ws.pack(weights)
        low = make_frames(C, B, frames, torch.bfloat16, device)
        slab = ws.interp(low, U, drop_last=True)
        full_ms = cuda_time_ms(lambda: ws.wavenet_stack(x, slab, packed, REGISTRY_DILS))
        interp_ms = cuda_time_ms(lambda: ws.interp(low, U, drop_last=True))
        low_ms = cuda_time_ms(lambda: ws.wavenet_stack(x, low, packed, REGISTRY_DILS, cond_upsampling=U)) \
            if ws.upsampled else float("nan")
        print(f"bf16 C={C} B={B} rows={frames * U}: K1 frame-rate cond {low_ms:.3f} ms, K1 full-rate slab "
              f"{full_ms:.3f} ms + interpolation {interp_ms:.3f} ms", flush=True)
        del x, weights, packed, low, slab


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).absolute().parent.parent),
                    help="the checkout whose mbexwn_vocoder_torch runs")
    ap.add_argument("--digest", action="store_true", help="only the shared-cond outputs' digests")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).absolute()))
    from mbexwn_vocoder_torch.ops import interp, kernel_lib, precision, wavenet_stack as ws_mod

    ws = argparse.Namespace(wavenet_stack=ws_mod.wavenet_stack, plain=ws_mod.wavenet_stack_plain,
                            pack=ws_mod.pack_stack_weights, exact_fp32=precision.exact_fp32,
                            interp=interp.linear_interp_upsample,
                            upsampled="cond_upsampling" in inspect.signature(ws_mod.wavenet_stack).parameters)
    if not torch.cuda.is_available():
        print("torch_k1_check: FAIL no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kernel_lib.library()
    print(f"build {kernel_lib.build_info.get('seconds', 0.0):.1f} s on {torch.cuda.get_device_name(0)} "
          f"({kernel_lib.__file__})")
    for line in kernel_lib.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or "warning" in line or line.startswith("=="):
            print("   ", line.strip())
    if args.digest:
        digests(ws, device)
        return 0
    failed = 0
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        for per_layer, cases in ((False, CASES), (True, PER_LAYER_CASES)):
            for C, B, T, dils in cases:
                if dtype == torch.float32 and T > 1000 and not (per_layer and B == 1):
                    continue  # the fp32 FMA kernel is the reference mode: small shapes and one WaveGlow WN
                x, cond, weights = make_case(C, B, T, dils, dtype, device, per_layer=per_layer)
                with ws.exact_fp32():
                    got = ws.wavenet_stack(x, cond, weights, dils)
                    torch.cuda.synchronize()
                    ref = ws.plain(x, cond, weights, dils)
                rel = rel_rms(got, ref)
                ok = bool(torch.isfinite(got).all()) and rel <= (1e-4 if dtype == torch.float32 and per_layer else tol)
                if per_layer:  # all slabs equal to layer 0's: the shared call's output, bit for bit
                    same = cond[:, :, :1].expand_as(cond).contiguous()
                    ok &= torch.equal(ws.wavenet_stack(x, same, weights, dils),
                                      ws.wavenet_stack(x, cond[:, :, 0].contiguous(), weights, dils))
                failed += not ok
                print(f"{'ok  ' if ok else 'FAIL'} {str(dtype)[6:]} C={C} B={B} T={T} layers={len(dils)} "
                      f"{'per-layer' if per_layer else 'shared'} cond: rel-RMS {rel:.3e}, max abs "
                      f"{float((got - ref).abs().max()):.3e}", flush=True)
                del x, cond, weights, got, ref
    if ws.upsampled:
        failed += check_upsampled(ws, device)
    for C in (320, 340):
        total = 0.0
        for T in (12800, 25600):
            x, cond, weights = make_case(C, 1, T, REGISTRY_DILS, torch.bfloat16, device)
            packed = ws.pack(weights)
            ms = cuda_time_ms(lambda: ws.wavenet_stack(x, cond, packed, REGISTRY_DILS))
            flop = T * C * C * (16.0 * (len(REGISTRY_DILS) - 1) + 14.0)
            total += ms
            print(f"bf16 C={C} rows={T}: {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s)", flush=True)
        print(f"bf16 C={C}: K1 per 512-frame synthesis {total:.3f} ms")
    time_upsampled(ws, device)
    for B, T in ((1, 16384), (8, 32768)):
        x, cond, weights = make_case(256, B, T, WAVEGLOW_DILS, torch.bfloat16, device, per_layer=True)
        packed = ws.pack(weights)
        flop = B * T * 256 * 256 * (16.0 * 7 + 14.0)
        ms = cuda_time_ms(lambda: ws.wavenet_stack(x, cond, packed, WAVEGLOW_DILS), iters=20)
        print(f"bf16 WaveGlow WN C=256 B={B} rows={T}: {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s)", flush=True)
        if B == 1:
            with ws.exact_fp32():
                pms = cuda_time_ms(lambda: ws.plain(x, cond, packed, WAVEGLOW_DILS), iters=5)
            print(f"plain WaveGlow WN C=256 B=1 rows={T}: {pms:.3f} ms", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
