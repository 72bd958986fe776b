#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero and
prints no result line:
  1. build the CUDA kernels of mbexwn_vocoder_torch/csrc (build seconds);
  2. K1 (wavenet_layer) against its plain PyTorch version on the card, with
     the registry weights of SPEECH (C=320) and VOICE (C=340), at both shapes
     the main path gives it at 512 mel frames: WaveNet block 0 (12,800 rows)
     and block 1 (25,600 rows).  fp32 with TF32 off, rel-RMS <= 1e-4
     (summation order only); bf16, rel-RMS <= 2e-2 (bf16 rounding of x and
     of the gated activation at other points).  Then a batched, ragged case
     in bf16: VOICE block 0's inputs stretched to T = 12,837 (not a multiple
     of the 128-row tile) and stacked with their time reversal to B = 2;
  3. K2, the whole oscillator stage (F0 -> phase -> lookup -> cross-fade) in
     one launch, against its plain version on the card: (a) SPEECH's tables,
     B=1, T=76,800, F0 sweeping 40-600 Hz; (b) B=3, T=12,345 (no multiple of
     the 1000-sample phase chunk) with a phase offset; (c) VOICE's tables.
     Audio max abs <= 1e-5; the phase it returns bit-equal to the plain
     version's on the card and on the CPU (the count of differing samples
     is printed);
  4. end to end: MELInverter("SPEECH") and MELInverter("VOICE") on the card
     with a 512-frame mel made from a seed.  fp32: within 1e-3 rel-RMS of the
     port's own CPU run with the same injected noise.  bf16 (the shipped
     mode, the main path): finite, of the right length, and the launch
     counts, reset just before and read just after, show K1 and K2 ran;
  5. times (CUDA events): each kernel, its plain version and its bound at
     the main path's shapes.  K2 and what it is held against are timed
     device-paced (`device_time_ms`: the host enqueues every call while a
     spin kernel holds the card), beside the floor of an empty launch and of
     a cooperative launch that only crosses one grid barrier, and
     `library_ms`: F.grid_sample on precomputed coordinates, which computes
     the lookup and cross-fade but not the phase; end-to-end synthesis ms
     and audio-seconds per second at batch 1, 512 frames, bf16, after
     warm-up;
  6. one synthesis under torch.profiler: device busy time, the count of
     device activities, idle share and the kernels that take the most
     device time; a trace with no device activity fails.
The last lines are a one-line summary of the end-to-end numbers, the card's
name and power limit, a `kernels` JSON line, and
`{"ok": true, "device": {...}}`.  Needs no network and no JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12  # HBM3 peak
N_FRAMES = 512
SEED = 1234


def rel_rms(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))


def make_mel(n_frames: int, n_mels: int, seed: int) -> np.ndarray:
    """A deterministic log-mel (1, n_frames, n_mels) with a spectral tilt,
    formant-like bumps and slow level changes, as speech gives."""
    rng = np.random.RandomState(seed)
    band = np.arange(n_mels)[None, :]
    t = np.arange(n_frames)[:, None]
    tilt = -2.0 - 0.06 * band
    formants = sum(1.5 * np.exp(-0.5 * ((band - (c + 4 * np.sin(2 * np.pi * t / p))) / w) ** 2)
                   for c, p, w in ((8, 97, 3.0), (22, 61, 4.0), (40, 131, 6.0)))
    level = 1.5 * np.sin(2 * np.pi * t / 173.0)
    mel = tilt + formants + level + 0.3 * rng.randn(n_frames, n_mels)
    return mel[None].astype(np.float32)


def k1_work(B: int, T: int, C: int, n_layers: int):
    """(operations, bytes) one 12-layer stack must do: per row 16*C^2 FLOP a
    layer (the 3-tap C -> 2C conv and the C -> 2C res/skip product), 14*C^2
    for the skip-only last layer (C -> C); bf16 x, cond and weights read
    once, the fp32 skip sum written once."""
    flop = B * T * C * C * (16.0 * (n_layers - 1) + 14.0)
    weight_elems = n_layers * 8 * C * C - C * C
    return flop, 2.0 * B * T * C + 2.0 * B * T * 2 * C + 2.0 * weight_elems + 4.0 * B * T * C


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time per call of `fn`, free of the host's pace: a spin kernel
    (`torch.cuda._sleep`) holds the card while the host enqueues every call,
    then the calls run back to back between two events.  While the start
    event has completed before the host is done (the spin was too short, or
    the launch queue filled up), the spin is doubled and the calls halved."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    cycles = int(2e6 * (3.0 * host_ms + 1.0))  # at most 2 GHz: at least 3x the host's time
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / iters
        cycles, iters = 2 * cycles, max(1, iters // 2)
    raise RuntimeError("the host did not get ahead of the card: no device-paced time")


def trace_synthesis(inv, mel, synth_ms: float, top: int = 8):
    """Profile one synthesis: device busy time (the union of kernel and copy
    intervals), the idle share against the untraced synthesis time, and the
    kernels that take the most device time, and the oscillator kernel's.
    Returns (idle share, device activities); (None, 0) when the profiler saw
    no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        inv.synth_from_mel(mel)
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (end - start) / 1e3, n + 1)
    if not spans:
        print("  trace: the profiler recorded no device activity", flush=True)
        return None, 0
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    busy_ms = busy_us / 1e3
    idle = max(0.0, 1.0 - busy_ms / synth_ms)
    print(f"  device busy {busy_ms:.3f} ms in {len(spans)} device activities; untraced synthesis "
          f"{synth_ms:.2f} ms -> device idle share {idle:.3f}", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:top] + [kv for kv in ranked[top:] if "oscillat" in kv[0]]:
        print(f"    {ms:9.4f} ms {n:5d}x  {name[:80]}", flush=True)
    return idle, len(spans)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    try:
        from mbexwn_vocoder_torch.mel_inverter import MELInverter
        from mbexwn_vocoder_torch.ops import kernel_lib
        from mbexwn_vocoder_torch.ops.oscillator import PHASE_CHUNK, oscillate, oscillate_plain
        from mbexwn_vocoder_torch.ops.precision import exact_fp32
        from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
    except ImportError as e:
        print(f"chip_smoke: FAIL the port is not importable from here: {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda:0")
    failures = []

    def check(ok: bool, what: str):
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            failures.append(what)

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        card = "unknown"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} ({card})",
          flush=True)

    # ---- 1. build
    print("[1] build", flush=True)
    t0 = time.perf_counter()
    kernel_lib.library()
    print(f"  build {time.perf_counter() - t0:.1f} s (nvcc {kernel_lib.build_info.get('seconds', 0.0):.1f} s, "
          f"cached={kernel_lib.build_info.get('cached')})", flush=True)
    for line in kernel_lib.build_info.get("log", "").splitlines():
        if "Used" in line or "spill" in line or line.startswith("=="):
            print("   ", line.strip())

    mel = make_mel(N_FRAMES, 80, SEED)
    inverters = {}

    def inverter(model_id: str, wn_dtype: str, device="cuda"):
        """MELInverter with the WaveNet/subnet compute dtype forced (an empty
        value is fp32; None keeps the shipped config: bf16)."""
        key = (model_id, wn_dtype, device)
        if key not in inverters:
            for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
                if wn_dtype is None:
                    os.environ.pop(var, None)
                else:
                    os.environ[var] = wn_dtype
            inverters[key] = MELInverter(model_id, device=device)
        return inverters[key]

    def stack_inputs(inv, block_index: int, dtype):
        """The real inputs of WaveNet block `block_index`'s stack for `mel`."""
        model, blk = inv.model, inv.model.block
        with torch.inference_mode(), exact_fp32():
            x_mel = torch.from_numpy(mel).to(dev)
            mell, _ = model.norm_mel_components.normalize_inputs_by_rms(x_mel, N_FRAMES * inv.hop_size)
            f0 = blk.generate_f0(mell)
            x = blk.fold_pulse_channels(blk.oscillate(f0), generator=torch.Generator(device=dev).manual_seed(0))
            for name in blk.block_names[:block_index]:
                x = getattr(blk, name)(x, mell)
            wn = getattr(blk, blk.block_names[block_index]).wavenet
            started = wn.start(x.to(dtype))
            cond = wn.cond_linup(wn.cond(mell.to(dtype))).contiguous()
            return started, cond, wn.stack_weights(dtype), wn.dilations

    # ---- 2. K1 vs plain
    print("[2] K1 wavenet_layer vs plain (blocks 0 and 1, 512 frames)", flush=True)
    k1_err = {}
    for model_id in ("SPEECH", "VOICE"):
        inv = inverter(model_id, "")
        for block_index in range(len(inv.model.block.block_names)):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x, cond, weights, dils = stack_inputs(inv, block_index, dtype)
                with torch.inference_mode(), exact_fp32():
                    got = wavenet_stack(x, cond, weights, dils)
                    ref = wavenet_stack_plain(x, cond, weights, dils)
                    torch.cuda.synchronize()
                g, r = got.cpu().numpy(), ref.cpu().numpy()
                err = rel_rms(g, r)
                max_abs = k1_err[(model_id, block_index, dtype)] = float(np.max(np.abs(g - r)))
                check(np.isfinite(g).all() and err <= tol,
                      f"K1 {model_id} block {block_index} C={x.shape[-1]} rows={x.shape[1]} {str(dtype)[6:]}: "
                      f"rel-RMS {err:.3e} (<= {tol:g}), max abs {max_abs:.3e}")
    inv = inverter("VOICE", "")
    x, cond, weights, dils = stack_inputs(inv, 0, torch.bfloat16)
    with torch.inference_mode(), exact_fp32():
        x2 = torch.cat([x, x[:, :37]], dim=1)
        c2 = torch.cat([cond, cond[:, :37]], dim=1)
        x2, c2 = torch.cat([x2, x2.flip(1)], dim=0).contiguous(), torch.cat([c2, c2.flip(1)], dim=0).contiguous()
        got = wavenet_stack(x2, c2, weights, dils)
        ref = wavenet_stack_plain(x2, c2, weights, dils)
        torch.cuda.synchronize()
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    err = rel_rms(g, r)
    check(np.isfinite(g).all() and err <= 2e-2,
          f"K1 VOICE block 0 batched and ragged, B={x2.shape[0]} T={x2.shape[1]} C={x2.shape[2]} bfloat16: "
          f"rel-RMS {err:.3e} (<= 0.02), max abs {float(np.max(np.abs(g - r))):.3e}")
    # the main path runs bf16: its largest error at any of its shapes
    k1_max_abs = max(e for (_, _, dtype), e in k1_err.items() if dtype == torch.bfloat16)

    # ---- 3. K2 vs plain
    print("[3] K2 oscillator stage (F0 -> phase -> lookup -> cross-fade) vs plain", flush=True)
    k2_err = 0.0
    for model_id, B, T, with_offset in (("SPEECH", 1, 76_800, False), ("SPEECH", 3, 12_345, True),
                                        ("VOICE", 1, 76_800, False)):
        blk = inverter(model_id, "").model.block
        wt = blk.wavetable
        consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition, wt.sample_rate)
        sweep = 40.0 * (600.0 / 40.0) ** np.linspace(0, 1, B * T)
        f0_cpu = torch.from_numpy(sweep.reshape(B, T).astype(np.float32))
        off_cpu = torch.from_numpy(np.random.RandomState(SEED).rand(B).astype(np.float32)) if with_offset else None
        f0, off = f0_cpu.to(dev), None if off_cpu is None else off_cpu.to(dev)
        with torch.inference_mode():
            got, phase = oscillate(f0, blk.wavetables, *consts, phase_offset=off, return_phase=True)
            ref, ref_phase = oscillate_plain(f0, blk.wavetables, *consts, phase_offset=off, return_phase=True)
            torch.cuda.synchronize()
            cpu_phase = oscillate_plain(f0_cpu, blk.wavetables.cpu(), *consts, phase_offset=off_cpu,
                                        return_phase=True)[1]
        err = float((got - ref).abs().max())
        k2_err = max(k2_err, err)
        diff_card, diff_cpu = int((phase != ref_phase).sum()), int((phase.cpu() != cpu_phase).sum())
        check(math.isfinite(err) and err <= 1e-5 and diff_card == 0 and diff_cpu == 0,
              f"K2 {model_id} tables {tuple(blk.wavetables.shape)} B={B} T={T}"
              f"{' with phase_offset' if with_offset else ''}: audio max abs {err:.3e} (<= 1e-5); phase samples "
              f"differing from plain on the card {diff_card}, on the CPU {diff_cpu} (of {B * T})")

    # ---- 4. end to end
    print("[4] end to end, 512 frames", flush=True)
    main_launches = None
    for model_id in ("SPEECH", "VOICE"):
        gpu = inverter(model_id, "")
        noise = np.random.RandomState(SEED + 1).randn(*gpu.noise_shape(mel)).astype(np.float32)
        y_gpu = gpu.synth_from_mel(mel, noise=noise)
        cpu = inverter(model_id, "", device="cpu")
        t0 = time.perf_counter()
        y_cpu = cpu.synth_from_mel(mel, noise=noise)
        cpu_s = time.perf_counter() - t0
        err = rel_rms(y_gpu, y_cpu)
        check(y_gpu.shape == (N_FRAMES * gpu.hop_size,) and np.isfinite(y_gpu).all() and err <= 1e-3,
              f"{model_id} fp32 card vs CPU: rel-RMS {err:.3e} (<= 1e-3), CPU run {cpu_s:.1f} s")

        shipped = inverter(model_id, None)
        check(shipped.model.block.wn_compute_dtype == torch.bfloat16, f"{model_id} shipped WaveNet dtype is bf16")
        shipped.synth_from_mel(mel)  # warm-up
        torch.cuda.synchronize()
        # the main path: counts set to 0 just before, read just after
        kernel_lib.reset_launch_counts()
        y16 = shipped.synth_from_mel(mel)
        counts = dict(kernel_lib.launches)
        n_layers = sum(getattr(shipped.model.block, n).wavenet.n_layers for n in shipped.model.block.block_names)
        check(y16.shape == (N_FRAMES * shipped.hop_size,) and bool(np.isfinite(y16).all()),
              f"{model_id} bf16: {y16.shape[0]} finite samples")
        check(counts == {"wavenet_layer": n_layers, "oscillator": 1},
              f"{model_id} bf16 launches {counts} (expected wavenet_layer={n_layers}, oscillator=1)")
        if model_id == "SPEECH":
            main_launches = counts

    # ---- 5. times
    print("[5] times (bf16, SPEECH, batch 1, 512 frames)", flush=True)
    inv = inverter("SPEECH", None)
    blk = inv.model.block
    k1_ms = k1_plain_ms = k1_flop = k1_bytes = 0.0
    for bi in range(len(blk.block_names)):
        x, cond, weights, dils = stack_inputs(inv, bi, torch.bfloat16)
        B, T, C = x.shape
        with torch.inference_mode(), exact_fp32():
            ms = cuda_time_ms(lambda: wavenet_stack(x, cond, weights, dils), iters=10)
            pms = cuda_time_ms(lambda: wavenet_stack_plain(x, cond, weights, dils), iters=5)
        flop, nbytes = k1_work(B, T, C, len(dils))
        k1_ms += ms
        k1_plain_ms += pms
        k1_flop += flop
        k1_bytes += nbytes
        print(f"  K1 block {bi}: rows {T} C {C} kernel {ms:.3f} ms plain {pms:.3f} ms "
              f"({flop / ms / 1e9:.1f} TFLOP/s)", flush=True)
    k1_bound = 1e3 * max(k1_flop / H100_BF16_FLOPS, k1_bytes / H100_BYTES_PER_S)
    k1_bound_by = "operations" if k1_flop / H100_BF16_FLOPS >= k1_bytes / H100_BYTES_PER_S else "bytes"

    wt = blk.wavetable
    n_osc = N_FRAMES * blk.spect_to_pulse_upsampling_factor
    f0 = torch.from_numpy(np.linspace(80.0, 300.0, n_osc, dtype=np.float32)[None]).to(dev)
    consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition, wt.sample_rate)
    tables = blk.wavetables
    lib, stream = kernel_lib.library(), torch.cuda.current_stream().cuda_stream
    n_chunks = -(-n_osc // PHASE_CHUNK)  # K2's grid: one CTA per chunk (77 <= 132 SMs, all resident)
    with torch.inference_mode():
        k2_ms = device_time_ms(lambda: oscillate(f0, tables, *consts), iters=200)
        k2_enqueued_ms = cuda_time_ms(lambda: oscillate(f0, tables, *consts), iters=200)
        k2_plain_ms = device_time_ms(lambda: oscillate_plain(f0, tables, *consts), iters=20)
        floors = {}
        for name, grid_sync, blocks in (("empty launch", 0, 1),
                                        (f"cooperative launch of {n_chunks} CTAs with one grid barrier", 1, n_chunks)):
            def launch():
                kernel_lib.check(lib.mbexwn_floor_launch(grid_sync, blocks, stream), "floor")
            floors[name] = (device_time_ms(launch, 200), cuda_time_ms(launch, 200))
        # the library yardstick: the lookup and cross-fade as one bilinear
        # grid_sample in the (n_wavetable, n_grid) table, zeros outside, on
        # coordinates computed beforehand from the kernel's own phase
        audio, phase = oscillate(f0, tables, *consts, return_phase=True)
        n_wt, n_grid = tables.shape
        gp = torch.log(torch.clamp(f0 / wt.nominalF0, wt.min_transposition, wt.max_transposition)) / math.log(
            wt.F0GridFactor)
        coords = torch.stack([gp * (2.0 / (n_grid - 1)) - 1.0, phase * 2.0 - 1.0], dim=-1).view(1, 1, n_osc, 2)
        image = tables.view(1, 1, n_wt, n_grid)

        def library_call():
            return torch.nn.functional.grid_sample(image, coords, mode="bilinear", padding_mode="zeros",
                                                   align_corners=True)

        library_diff = float((library_call().view(1, n_osc) - audio).abs().max())
        library_ms = device_time_ms(library_call, iters=200)
    k2_bytes = 8.0 * n_osc + tables.numel() * 4
    k2_flop = 40.0 * n_osc
    k2_bound = 1e3 * max(k2_bytes / H100_BYTES_PER_S, k2_flop / 67e12)
    print(f"  K2: samples {n_osc}, device-paced: kernel {k2_ms:.5f} ms, plain {k2_plain_ms:.5f} ms; bound "
          f"{k2_bound:.5f} ms (bytes: 8 B/sample + table at 3.35 TB/s); kernel as enqueued back to back "
          f"{k2_enqueued_ms:.5f} ms", flush=True)
    for name, (paced, enqueued) in floors.items():
        print(f"  floor: {name}: {paced:.5f} ms device-paced, {enqueued:.5f} ms as enqueued", flush=True)
    print(f"  K2 library_ms {library_ms:.5f}: one F.grid_sample (bilinear, zeros outside, align_corners) on "
          f"coordinates computed beforehand; it covers the lookup and cross-fade only, not the phase; "
          f"max abs {library_diff:.3e} from the kernel's audio", flush=True)

    for _ in range(3):
        inv.synth_from_mel(mel)
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        inv.synth_from_mel(mel)
    torch.cuda.synchronize()
    synth_ms = 1e3 * (time.perf_counter() - t0) / reps
    audio_s = N_FRAMES * inv.hop_size / inv.srate
    print(f"  end to end: synthesis {synth_ms:.2f} ms for {audio_s:.2f} s of audio = "
          f"{audio_s / (synth_ms / 1e3):.1f} audio-s/s (bf16, batch 1, {N_FRAMES} frames)", flush=True)
    print(f"  K1 per synthesis: kernel {k1_ms:.3f} ms plain {k1_plain_ms:.3f} ms bound {k1_bound:.4f} ms "
          f"({k1_bound_by}; 989 TFLOP/s bf16, 3.35 TB/s)", flush=True)
    print("  K1 library_ms: none: no single PyTorch call computes the gated dilated residual layer", flush=True)

    # ---- 6. where the time goes: one traced synthesis
    print("[6] trace (one bf16 synthesis, torch.profiler)", flush=True)
    idle, n_activities = trace_synthesis(inv, mel, synth_ms)
    check(n_activities > 0, f"trace: {n_activities} device activities in one synthesis")

    if failures:
        print(f"chip_smoke: FAIL {len(failures)} check(s): {failures}", flush=True)
        return 1

    kernels = [
        {"name": "wavenet_layer", "route": "cuda", "source": "mbexwn_vocoder_torch/csrc/wavenet_layer.cu",
         "replaces": "mbexwn_vocoder_tpu/ops/pallas_wavenet.py:106", "launches": main_launches["wavenet_layer"],
         "max_abs_err": k1_max_abs, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "oscillator", "route": "cuda", "source": "mbexwn_vocoder_torch/csrc/oscillator.cu",
         "replaces": "mbexwn_vocoder_tpu/ops/pallas_oscillator.py:49", "launches": main_launches["oscillator"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": library_ms},
    ]
    print(f"summary: SPEECH bf16 batch 1 {N_FRAMES} frames: synthesis {synth_ms:.2f} ms = "
          f"{audio_s / (synth_ms / 1e3):.1f} audio-s/s, device idle share {idle:.3f}, {n_activities} device "
          f"activities; K1 {k1_ms:.3f} ms (bound {k1_bound:.4f}), K2 {k2_ms:.5f} ms (bound {k2_bound:.5f}); "
          f"all checks passed", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
