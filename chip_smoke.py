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
     device time; a trace with no device activity fails;
  7. serving, SPEECH, shipped bf16, full width: 24 requests of 100-1000
     frames (6 in each of the buckets 128/256/512/1024) served by the
     blocking loop (`synth_from_mel` per request) and by
     PipelinedSynthesizer(depth=3) at batch 1 and at batch 8 (and at batch
     8 in shuffled order): audio-s/s on the host clock (median of 5
     interleaved rounds), the device idle share (profiler over the set),
     launches per dispatch group (K1 24, K2 1), and the PyTorch ops the sync
     debug mode flags; batch 1 must be bit-equal to
     the blocking loop.  A batch-8 group and BatchSynthesizer on 5 mixed
     lengths against single requests handed the same noise rows: bf16
     rel-RMS <= 2e-2, fp32 <= 1e-4.  K1 and K2 against their plain
     versions on the inputs of the request set's 1024-bucket group (B = 6:
     6 x 51,200 rows in block 1, 6 x 153,600 oscillator samples) and of the
     batch-8 group (bucket 512), bf16 and fp32, with phase [2]'s and [3]'s
     bounds; the kernels line's max_abs_err covers these shapes too.  The
     quality round trip on the 8 synth_eval_v2 utterances (seed 1099),
     served at batch 8: mean mel-L1 within 0.15 dB of the registry's
     quality_report.json;
  8. streaming, SPEECH, full width (`parallel.streaming.StreamingSynthesizer`
     on models from `models.create_registry_model`; "sigma-0" is the shipped
     model with its noise channel at zero and no mel RMS normalisation, the
     model chunked output can equal one-shot output with):
     (a) K1's causal taps against the plain version on the causal model's
     stack inputs: SPEECH blocks 0 and 1 at 512 frames and at the live span
     of 50 frames (32 + 16 + 2), fp32 <= 1e-4 and bf16 <= 2e-2 rel-RMS, and
     VOICE block 0 at 512 frames in bf16;
     (b) long form at the JAX package's bench setting (4800 frames = 60 s,
     chunk 512, halo 48): synth, synth_batched and synth_scan (interior)
     within 2e-3 of one-shot infer in fp32 in every chunk (bf16 printed
     against 2e-2); each pass's launches (K1 24 and K2 1 per chunk or
     batched group, counts set to 0 just before it) and K1 against its
     plain version on the inputs of every stack shape the pass gave it
     (spans of 560/608/240 frames at B=1, the batched group of 8 x 608),
     fp32 <= 1e-4 and bf16 <= 2e-2; K2 in one synth and one synth_scan pass
     bit-equal in phase to its plain version, chunk by chunk, with no phase
     jump at a chunk boundary (<= 1e-3 cycles), and each chunk's end phase
     and interior F0 against the one-shot's (printed); then one counted pass and the
     audio-s/s of the three modes with the shipped SPEECH model in bf16
     (host clock with the readback, median of 5 interleaved rounds after a
     warm pass) with device busy time and idle share;
     (c) live, force_causal sigma-0 SPEECH, halo 32, halo_right 2: K1
     against plain on every stack shape a live stream gives it (the spans of
     the left-halo ramp up to 38/42/50/66 frames at chunks 4/8/16/32), fp32
     and bf16; in fp32 stream() with slabs of 1/4/7 frames bit-equal to
     each other and to synth(), within 1e-3 of one-shot, halo_right=1
     beyond 1e-3, and after warm() at most one chunk shape warm() did not
     run; in bf16 at chunks of 4/8/16/32 frames the latency from the call
     for a chunk to its audio
     on the host (median and p95 of 30 steady chunks), the launches per
     chunk (K1 24, K2 1), and one steady chunk's device busy time and idle
     share (torch.profiler).  The model's stack calls in (b) and (c) never
     reach the plain stack with a CUDA tensor (the comparisons call it
     directly);
  9. training (`training.Trainer`, the differentiable route: the WaveNet
     layer by layer and `oscillate_plain`; neither kernel has a backward
     pass):
     (a) K1 and K2 raise on CUDA inputs that require grad;
     (b) the CPU tests' tiny case (`training.parity.card_against_cpu`:
     SPEECH with a 16-channel, 2-layer WaveNet), one set of params,
     injected draws: in fp64 the card's loss within 1e-12 of the CPU's and
     every gradient leaf within 1e-9 rel-RMS (leaves under 1e-6 of the
     largest norm within 1e-7 absolute); in fp32 the loss within 1e-5, and
     each device's fp32 gradients against the CPU's fp64 ones reported;
     (c) full width: SPEECH as shipped (C = 320, 2 x 12 layers) from its
     weights.npz in the trainable form, bf16 compute, its training_config
     (Adam 1e-4; the four-resolution STFT, NPOW and mel losses; F0 loss,
     teacher forcing, coherence), segments of 24,000 samples (81 frames),
     batch 32 (or the largest that fits, the cut printed) of synth_utterance
     audio through the port's analysis front end: 20 steps on that batch,
     every loss finite and the loss falling (mean of the last 5 below the
     mean of the first 5); step time, median of 10 steps after 2 warm-up
     steps, by CUDA events and by the host clock, beside the WaveNet's
     forward + backward bound (3 x K1's operations at 989 TFLOP/s); peak
     memory; one step's device busy time and idle share (torch.profiler);
     (d) the trained model folded (`fold_()`): its own 512-frame synthesis
     on the card finite, with 24 K1 and 1 K2 launches; then written with
     save_params and loaded by MELInverter on the card: a 512-frame
     synthesis finite, with 24 K1 and 1 K2 launches;
 10. the training CLI and its parts, SPEECH as shipped (C = 320, 12 + 12 layers, bf16),
     its training_config (batch 32 of 24,000-sample segments), on a corpus
     of 16 synthetic utterances (`training.synthetic.make_corpus`, seed 0)
     in a temporary directory outside the repo:
     (a) `cli.train.main` warm-started from the registry's weights.npz
     (--init_from), 10 steps, save_every 5, log_every 1, 2 loader workers,
     then resumed to 15 (the checkpoint wins over --init_from):
     metrics.jsonl holds steps 1-15, all finite; checkpoints 5, 10 and 15;
     the step-15 checkpoint restored into a fresh trainer on the card
     equals the trained state bit for bit (parameters, Adam state,
     scheduler count, step); replaying --steps 15 prints "nothing to train"
     and builds no model, and the same replay with --init_from does not
     skip; the export loaded by MELInverter synthesises 512 frames with 24
     K1 + 1 K2 launches, finite, and K1 on its two stacks (fp32 <= 1e-4,
     bf16 <= 2e-2 rel-RMS) and K2 on its F0 (audio <= 1e-5, phase
     bit-equal) against their plain versions.  Printed: the CLI's step
     (host clock, median of steps 3-10) beside [9](c)'s, the card's busy
     time and idle share over steps 6-10 (torch.profiler tracing the card
     only, from step 6's train_step to step 10's metrics), the loader's
     ms per batch per worker and queue depth, time to the first step,
     checkpoint save ms and bytes, peak memory;
     (b) `training.pretrain.pretrain_activations` from a fresh init on two
     calibration batches of 32 mels, 5 iterations: the stats loss finite
     and falling, the frozen leaves bit-equal; ms an iteration, peak
     memory;
     (c) `training.adversarial.AdversarialTrainer` from the shipped
     weights, default wavegan_config, 5 steps on one batch of 32: every
     loss finite, step ms (CUDA events), peak memory; and the tiny case's
     GAN step in fp64 on the card against the CPU
     (`training.parity.gan_card_against_cpu`): metrics within 1e-12,
     every generator and discriminator gradient leaf within 1e-9 rel-RMS.
 11. the parallel layer (`parallel.mesh`, `parallel.multihost`, the
     data-parallel `Trainer`, `cli.train --n_devices`):
     (a) the tiny fp64 case of `training.parity` (`dp_against_single`) on
     two spawned processes that share the card over gloo (NCCL refuses two
     ranks on one card), at a global batch of 4 whose shards hold different
     numbers of voiced frames: one `Trainer` and one `AdversarialTrainer`
     step against the one-process step, every metric within 1e-12, every
     gradient leaf and updated parameter within 1e-9 rel-RMS, and a
     per-rank mean (DDP's rule) shown to be off by more than 1e-6;
     (b) SPEECH as shipped (bf16) at [9](c)'s global batch and draws, one
     spawned rank per card over NCCL, 10 steps: step ms (CUDA events)
     beside [9](c)'s, the gradient sync's ms a step, peak memory, and step
     1's loss against [9](c)'s first step (<= 1e-3 at one card);
     (c) `cli.train --n_devices 0` (a process group even at one card): 5
     steps warm-started from the registry weights, a checkpoint at 5, the
     export synthesised through K1 and K2 and each held against its plain
     version as in [10](a); the host step beside [10](a)'s;
     (d) `BatchSynthesizer(mesh=make_mesh())` (and, on a host with one
     card, a two-replica mesh on cuda:0 so that the shard, pad and gather
     code runs) on [7]'s request set against mesh=None: bf16 <= 2e-2, fp32
     <= 1e-4 rel-RMS, K1 against plain at the shapes the mesh gave it,
     audio-s/s and idle share beside [7]'s batch 8; `synth_batched` over
     the same meshes on [8]'s 60 s long form against mesh=None (fp32 <=
     1e-4, bf16 reported) with its audio-s/s; launches per device.
 12. the AOT export path, remat training and the diagnostics, SPEECH as
     shipped at full width:
     (a) `compat.export.export_synthesis` at 512 frames on the card (bf16
     at batch 1 and 8, fp32 at batch 1): each artifact loaded and run in a
     fresh process (`chip_smoke.py --artifact-child DIR`) that imports none
     of the port's models, nn, config or mel_inverter: one call's launches
     (24 K1 + 1 K2), the audio against `MELInverter.synth_from_mel` (batch
     1) or `BatchSynthesizer` (batch 8) given the same noise rows (fp32
     <= 1e-5, bf16 <= 2e-2 rel-RMS; bit-equal printed), the call's ms by
     CUDA events and by the host clock with the copies beside [5]'s
     synthesis; export s, artifact bytes, load s;
     (b) [9](c)'s configuration, batch and draws with
     remat_wavenet_blocks: step 1's loss equal to [9](c)'s, peak memory
     below [9](c)'s, the step by CUDA events (median of steps 3-6); the
     worst fp32 gradient leaf against the non-remat step on the same
     draws (reported); the tiny fp64 case, card remat against card
     non-remat (loss and every leaf within 1e-12);
     (c) `observability`: `profile_trace` over one bf16 synthesis writes a
     trace naming K1's kernel; `debug_nans` silent over one synthesis (its
     cost printed) and raising on a NaN planted in the mel; `dump_controls`
     at 512 frames; `synthesis_flops(SPEECH, 512, 1)` with the FLOP/s it
     implies at [5]'s synthesis time; each synthesis 24 K1 + 1 K2;
 13. every route of the WaveNet stack, SPEECH full width (C=320): (a) the
     branches the kernel does not take (gates glu and gsu, n_ch_groups 2,
     kernel_size 5 on SPEECH), and per-layer conditioning on a standalone
     stack (K1's since WaveGlow), random init: fp32 card against the port's
     CPU <= 1e-3 rel-RMS, K1 launches 0 (24 for the unedited gtu reference,
     12 for the per-layer stack), bf16 ms;
     (b) tensor parallelism (MBEXWN_TP_AXIS=model, the shipped weights, a
     1 x 2 mesh of cuda:0 twice, BatchSynthesizer at batch 2) against the
     same model unsharded (fp32 <= 1e-5, bf16 <= 2e-2), K1 launches 0, ms
     and the reduce's share of the device time; (c) the int8 mode
     (MBEXWN_WN_QUANT=int8, shipped bf16, batch 1 and 8): each int8 layer
     of the card's synthesis against the port's CPU on the same inputs
     <= 2e-2 (the whole synthesis card against CPU is read: bin flips
     spread downstream), against card bf16 > 1e-3, 48 torch._int_mm
     calls a synthesis, ms beside bf16, and the quality round trip's mel-L1
     beside [7]'s (recorded); (d) the int8 artifact at batch 1 in a fresh
     process against the direct int8 synthesis (bit-equal, or < 1e-2 and
     < 0.1 x its distance to bf16).
 14. the model's opt-in branches, SPEECH full width (C=320, 2 x 12 layers),
     random init: (a) the sinusoid and analytic-pulse oscillator modes,
     subharmonic channels, the pulse-channel PQMF fold, no PQMF synthesis,
     the multiband gains (ps_use_stft false), ps_off, the envelope without
     cepstral windows, without a range limit, with the cepstral-loss
     constraint, with energy preservation, internal_fft_over 1, one NormMel
     with every option, leaky-ReLU subnets with remove_inactive_pad_layers,
     and equalized LR without weight norm: fp32 card against the port's
     CPU <= 1e-4 rel-RMS, K1 24 and K2 1 launches a synthesis (the analytic
     pulse: K2 0), bf16 ms beside the unedited config's in the same round;
     (b) K2 against its plain version on the subharmonic model's call and
     the pulse-gain calls (audio <= 1e-5, phase bit-equal), the analytic
     pulse's phase bit-equal to K2's, K1 against its plain version on the
     subharmonic, PQMF-fold and equalized-LR models' stack inputs (fp32 <=
     1e-4, bf16 <= 2e-2), the pulse-gain scans card against CPU; (c)
     `synth_batched` on 20 s over a 1 x 2 grid of cuda:0 twice with
     MBEXWN_TP_AXIS=model against mesh=None (fp32 <= 1e-5, bf16 <= 2e-2);
     (d) the int8 mode under tensor parallelism on that grid, each sharded
     int8 layer against the unsharded one on the same inputs (<= 2e-3), ms
     beside unsharded int8 and tensor-parallel bf16; (e) the tiny fp64
     training step with the envelope's aux losses, card against CPU (loss
     1e-12, leaves 1e-9).
 15. WaveGlow (models/waveglow.py) at its published widths, seeded weights
     (benchmark/configs/waveglow.json): (a) fp32 and bf16 synthesis of 64
     frames against the plain reference (tests/waveglow_reference.py) on
     the card (fp32 <= 1e-4, bf16 <= 0.05 rel-RMS), every WN on route k1,
     96 K1 launches a synthesis; (b) one WN, its cond the real cond conv's
     output: at batch 1 and 512 frames K1, the whole WN, K1's bound and
     plain ms, and K1 against its plain version there and at batch 8 of
     bucket 1024 (32,768 rows an utterance, a 2.15 GB cond; 8 launches),
     bf16 <= 2e-2 rel-RMS; (c) PipelinedSynthesizer at batch 8 in bucket
     1024: 96 launches a group, ms a group, peak memory.
     `chip_smoke.py --waveglow` runs [1]'s build and [15] alone.
The last lines are a one-line summary of the end-to-end numbers, a
`serving:` JSON line with phase [7]'s numbers, a `streaming:` JSON line
with phase [8]'s, a `training:` JSON line with phase [9]'s, a
`training_driver:` JSON line with phase [10]'s, a `parallel:` JSON line
with phase [11]'s, an `export_remat_observability:` JSON line with phase
[12]'s, a `routes:` JSON line with phase [13]'s, a `branches:` JSON line
with phase [14]'s, a `waveglow:` JSON line with phase [15]'s, the card's
name and power limit, a `kernels` JSON line
(its launches: the main path of [4], SPEECH bf16, plus one pass of each
long-form mode of [8](b), the live streams of [8](c), the trained and the
reloaded model's syntheses of [9](d), the CLI export's synthesis of
[10](a), and [11]'s: the data-parallel CLI export's synthesis and the bf16
mesh passes of (d); [12]'s: one call of each loaded artifact and the
syntheses under profile_trace, debug_nans and dump_controls; [13]'s
syntheses on every route and the int8 artifact's call; [14]'s branch
syntheses, pulse-gain calls, streaming passes and int8 synthesis over a
model axis; [15]'s syntheses, its batch-8 WN and its groups; each counted
from 0 just before it), and
`{"ok": true, "device": {...}}`.
Needs no network and no JAX.
"""
from __future__ import annotations

import contextlib
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


def stack_inputs(model, mel: np.ndarray, block_index: int, dtype, dev):
    """The real inputs of WaveNet block `block_index`'s stack in `model` (a
    PaNWaveNet) for a (B, T, C) log-mel at its bucket length, with the noise
    the model draws (a generator seeded 0): (x, cond, weights, dilations, the
    F0 that enters the oscillator)."""
    import torch
    from mbexwn_vocoder_torch.ops.precision import exact_fp32

    blk = model.block
    with torch.inference_mode(), exact_fp32():
        mell = torch.from_numpy(mel).to(dev)
        if model.norm_mel_components is not None:
            _, mell, _ = model.norm_mel_components.normalize_inputs_by_rms(None, mell,
                                                                            mel.shape[1] * model.spect_hop_size)
        f0 = blk.generate_f0(mell)
        x = blk.fold_pulse_channels(blk.oscillate(f0), generator=torch.Generator(device=dev).manual_seed(0))
        for name in blk.block_names[:block_index]:
            x = getattr(blk, name)(x, mell)
        wn = getattr(blk, blk.block_names[block_index]).wavenet
        started = wn.start(x.to(dtype))
        cond = wn.cond_linup(wn.cond(mell.to(dtype))).contiguous()
        return started, cond, wn.stack_weights(dtype), wn.dilations, f0


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


def device_activity(fn):
    """Run fn() once under torch.profiler: (device busy ms, the union of kernel
    and copy intervals; the count of device activities; {name: (ms, n)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_busy(prof)


def device_busy(prof):
    """(device busy ms, the count of device activities, {name: (ms, n)}) of a
    finished torch.profiler run: the union of its kernel and copy intervals."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (end - start) / 1e3, n + 1)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    return busy_us / 1e3, len(spans), by_name


def trace_synthesis(inv, mel, synth_ms: float, top: int = 8):
    """Profile one synthesis: device busy time, the idle share against the
    untraced synthesis time, and the kernels that take the most device time,
    and the oscillator kernel's.  Returns (idle share, device activities);
    (None, 0) when the profiler saw no device activity."""
    busy_ms, n_spans, by_name = device_activity(lambda: inv.synth_from_mel(mel))
    if not n_spans:
        print("  trace: the profiler recorded no device activity", flush=True)
        return None, 0
    idle = max(0.0, 1.0 - busy_ms / synth_ms)
    print(f"  device busy {busy_ms:.3f} ms in {n_spans} device activities; untraced synthesis "
          f"{synth_ms:.2f} ms -> device idle share {idle:.3f}", flush=True)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in ranked[:top] + [kv for kv in ranked[top:] if "oscillat" in kv[0]]:
        print(f"    {ms:9.4f} ms {n:5d}x  {name[:80]}", flush=True)
    return idle, n_spans


SERVE_BUCKETS = ((100, 128), (129, 256), (257, 512), (513, 1000))  # request lengths per bucket, frames
GROUP_FRAMES = (300, 512)  # the batch-8 group's lengths: bucket 512
MIXED_FRAMES = (150, 420, 90, 230, 500)  # BatchSynthesizer's five requests: buckets 128, 256 and 512


def serving_requests(n_mels: int, per_bucket: int = 6):
    """The request set of phase [7]: 24 log-mels of 100-1000 frames, 6 in each
    of the buckets 128/256/512/1024, arriving in runs of one bucket (as from
    a front end that orders its queue by length); lengths and mels from SEED."""
    rng = np.random.RandomState(SEED + 7)
    lengths = [int(rng.randint(lo, hi + 1)) for lo, hi in SERVE_BUCKETS for _ in range(per_bucket)]
    return [make_mel(T, n_mels, SEED + 100 + i) for i, T in enumerate(lengths)]


def phase_serving(inverter, check, dev):
    """Phase [7]: the serving path, SPEECH, shipped bf16, full width.  The
    request set three ways (the blocking loop, the pipeline at batch 1 and at
    batch 8): audio-s/s on the host clock, the device idle share over the set,
    launches per dispatch group; batch groups against single requests given
    the same noise rows; the quality round trip on synth_eval_v2.  Returns
    the serving numbers for the `serving:` line."""
    import tempfile
    import warnings

    import torch
    from mbexwn_vocoder_torch.compat.audio_io import read_wav
    from mbexwn_vocoder_torch.mel_inverter import edge_pad
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops.oscillator import oscillate, oscillate_plain
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
    from mbexwn_vocoder_torch.parallel.batch import BatchSynthesizer
    from mbexwn_vocoder_torch.quality import V2_EVAL_SETS, round_trip, summarize
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer
    from mbexwn_vocoder_torch.training.synthetic import make_corpus

    inv = inverter("SPEECH", None)
    blk = inv.model.block
    n_layers = sum(getattr(blk, n).wavenet.n_layers for n in blk.block_names)
    mels = serving_requests(inv.mel_channels)
    audio_s = sum(m.shape[1] for m in mels) * inv.hop_size / inv.srate
    print(f"  {len(mels)} requests, {audio_s:.2f} s of audio, frames {[m.shape[1] for m in mels]}", flush=True)

    def counted(ps):
        """ps with a count of its dispatch groups in ps.groups."""
        ps.groups = 0
        dispatch = ps._dispatch_group

        def wrapped(group, T_pad):
            ps.groups += 1
            return dispatch(group, T_pad)

        ps._dispatch_group = wrapped
        return ps

    pipes = {"pipelined batch 1": counted(PipelinedSynthesizer(inv.model, inv.length_buckets, depth=3, batch=1)),
             "pipelined batch 8": counted(PipelinedSynthesizer(inv.model, inv.length_buckets, depth=3, batch=8))}

    # arrival order without runs: coalescing stacks consecutive requests of one bucket only
    shuffled = [mels[i] for i in np.random.RandomState(SEED + 8).permutation(len(mels))]
    modes = {"blocking": (None, mels), "pipelined batch 1": (pipes["pipelined batch 1"], mels),
             "pipelined batch 8": (pipes["pipelined batch 8"], mels),
             "pipelined batch 8, shuffled arrival": (pipes["pipelined batch 8"], shuffled)}

    def serve(mode):
        ps, requests = modes[mode]
        return [inv.synth_from_mel(m) for m in requests] if ps is None else ps.map(requests)

    numbers, outputs = {}, {}
    for mode, (ps, requests) in modes.items():
        serve(mode)  # warm-up: cuDNN's choices and the allocators' blocks for these shapes
        torch.cuda.synchronize()
        if ps is not None:
            ps.groups = 0
        kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
        outputs[mode] = serve(mode)
        counts = dict(kernel_lib.launches)
        groups = len(requests) if ps is None else ps.groups
        check(counts == {"wavenet_layer": n_layers * groups, "oscillator": groups},
              f"{mode}: launches {counts} in {groups} dispatch groups (expected per group wavenet_layer="
              f"{n_layers}, oscillator=1)")
        check(all(y.shape == (m.shape[1] * inv.hop_size,) and np.isfinite(y).all()
                  for y, m in zip(outputs[mode], requests)), f"{mode}: every request finite and of its length")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                serve(mode)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in caught
                 if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
        busy_ms, n_act, _ = device_activity(lambda: serve(mode))
        numbers[mode] = {"device_busy_ms": busy_ms, "device_activities": n_act, "dispatch_groups": groups,
                         "k1_per_group": counts["wavenet_layer"] / groups,
                         "k2_per_group": counts["oscillator"] / groups, "synchronizing_ops": len(syncs),
                         "wall_ms_passes": []}
    same = sum(np.array_equal(a, b) for a, b in zip(outputs["blocking"], outputs["pipelined batch 1"]))
    check(same == len(mels), f"pipelined batch 1 bit-equal to the blocking loop: {same} of {len(mels)} requests")

    # the host's pace drifts: time the modes in interleaved rounds, the median per mode
    for _ in range(5):
        for mode in modes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(mode)
            numbers[mode]["wall_ms_passes"].append(1e3 * (time.perf_counter() - t0))
    for mode, nb in numbers.items():
        wall = float(np.median(nb["wall_ms_passes"]))
        nb.update(wall_ms=wall, audio_s_per_s=audio_s / (wall / 1e3),
                  idle_share=max(0.0, 1.0 - nb["device_busy_ms"] / wall))
        print(f"  {mode}: {nb['audio_s_per_s']:.1f} audio-s/s ({wall:.1f} ms for the set, median of "
              f"{', '.join(f'{w:.1f}' for w in nb['wall_ms_passes'])}); device busy {nb['device_busy_ms']:.2f} ms "
              f"in {nb['device_activities']} activities, idle share {nb['idle_share']:.3f}; "
              f"{nb['dispatch_groups']} dispatch groups, launches per group K1 {nb['k1_per_group']:g} "
              f"K2 {nb['k2_per_group']:g}; synchronizing ops flagged by the sync debug mode: "
              f"{nb['synchronizing_ops']}", flush=True)

    def noise_rows(inv_x, group_lengths):
        """The noise a dispatch group of these mel lengths draws (a generator
        seeded 0, shape (B, L, 1) on the card), one row per request."""
        L = inv_x.model.block.wn_input_length(inv_x._bucket_len(max(group_lengths)))
        g = torch.Generator(device=dev).manual_seed(0)
        noise = torch.randn((len(group_lengths), L, 1), generator=g, device=dev).cpu().numpy()
        return [noise[i:i + 1] for i in range(len(group_lengths))]

    rng = np.random.RandomState(SEED + 9)
    group = [make_mel(int(T), inv.mel_channels, SEED + 200 + i)
             for i, T in enumerate(rng.randint(GROUP_FRAMES[0], GROUP_FRAMES[1] + 1, 8))]
    mixed = [make_mel(T, inv.mel_channels, SEED + 300 + i) for i, T in enumerate(MIXED_FRAMES)]
    for wn_dtype, tol in ((None, 2e-2), ("", 1e-4)):
        inv_x = inverter("SPEECH", wn_dtype)
        name = "bf16" if wn_dtype is None else "fp32"
        T_pad = inv_x._bucket_len(max(m.shape[1] for m in group))
        with torch.inference_mode(), exact_fp32():
            xb = torch.from_numpy(np.concatenate([edge_pad(m, T_pad) for m in group])).to(dev)
            _, mell, _ = inv_x.model.norm_mel_components.normalize_inputs_by_rms(None, xb, T_pad * inv_x.hop_size)
            f0_b = inv_x.model.block.generate_f0(mell)
            f0_s = torch.cat([inv_x.model.block.generate_f0(mell[i:i + 1]) for i in range(len(group))])
            df0 = float((f0_b - f0_s).abs().max())
        got = PipelinedSynthesizer(inv_x.model, inv_x.length_buckets, depth=1, batch=8).map(group)
        rows = noise_rows(inv_x, [m.shape[1] for m in group])
        errs = [rel_rms(y, inv_x.synth_from_mel(m, noise=n)) for y, m, n in zip(got, group, rows)]
        check(max(errs) <= tol, f"{name} batch-8 group (bucket {T_pad}) vs the 8 single requests given its noise "
                                f"rows: max rel-RMS {max(errs):.3e} (<= {tol:g}); F0 net batch vs single max |dF0| "
                                f"{df0:.3e} Hz")

        bs = BatchSynthesizer(inv_x.model, length_buckets=inv_x.length_buckets)
        got = bs.synth_batch([m[0] for m in mixed])
        noise_of = {}
        by_bucket = {}
        for i in sorted(range(len(mixed)), key=lambda i: mixed[i].shape[1]):
            by_bucket.setdefault(inv_x._bucket_len(mixed[i].shape[1]), []).append(i)
        for idxs in by_bucket.values():  # at most 8 per bucket here: one chunk each
            noise_of.update(zip(idxs, noise_rows(inv_x, [mixed[i].shape[1] for i in idxs])))
        errs = [rel_rms(got[i], inv_x.synth_from_mel(mixed[i], noise=noise_of[i])) for i in range(len(mixed))]
        check(max(errs) <= tol, f"{name} BatchSynthesizer.synth_batch, frames {[m.shape[1] for m in mixed]} in "
                                f"{len(by_bucket)} bucket groups, vs single requests given their noise rows: max "
                                f"rel-RMS {max(errs):.3e} (<= {tol:g})")

    # both kernels against their plain versions at the largest shapes this phase gives them: the
    # request set's group in its top bucket (B = 6) and the batch-8 group, on the groups' own inputs
    runs = {}
    for m in mels:
        runs.setdefault(inv._bucket_len(m.shape[1]), []).append(m)
    top = max(runs)
    cases = ((runs[top], top), (group, inv._bucket_len(max(m.shape[1] for m in group))))
    k1_max_abs = k2_max_abs = 0.0
    for wn_dtype, dtype, tol in ((None, torch.bfloat16, 2e-2), ("", torch.float32, 1e-4)):
        inv_x = inverter("SPEECH", wn_dtype)
        blk_x = inv_x.model.block
        wt = blk_x.wavetable
        consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition, wt.sample_rate)
        for requests, T_pad in cases:
            xb = np.concatenate([edge_pad(m, T_pad) for m in requests])
            for bi in range(len(blk_x.block_names)):
                x, cond, weights, dils, f0 = stack_inputs(inv_x.model, xb, bi, dtype, dev)
                with torch.inference_mode(), exact_fp32():
                    g = wavenet_stack(x, cond, weights, dils).cpu().numpy()
                    r = wavenet_stack_plain(x, cond, weights, dils).cpu().numpy()
                err, max_abs = rel_rms(g, r), float(np.max(np.abs(g - r)))
                if dtype == torch.bfloat16:
                    k1_max_abs = max(k1_max_abs, max_abs)
                check(np.isfinite(g).all() and err <= tol,
                      f"K1 at a serving shape, block {bi} B={x.shape[0]} rows={x.shape[1]} (bucket {T_pad}) "
                      f"{str(dtype)[6:]}: rel-RMS {err:.3e} (<= {tol:g}), max abs {max_abs:.3e}")
            with torch.inference_mode():
                got, phase = oscillate(f0, blk_x.wavetables, *consts, return_phase=True)
                ref, ref_phase = oscillate_plain(f0, blk_x.wavetables, *consts, return_phase=True)
                err, n_diff = float((got - ref).abs().max()), int((phase != ref_phase).sum())
            k2_max_abs = max(k2_max_abs, err)
            check(math.isfinite(err) and err <= 1e-5 and n_diff == 0,
                  f"K2 at a serving shape, B={f0.shape[0]} T={f0.shape[1]} (bucket {T_pad}), F0 of the "
                  f"{str(dtype)[6:]} F0 net: audio max abs {err:.3e} (<= 1e-5); phase samples differing from "
                  f"plain {n_diff} (of {f0.numel()})")
    numbers["kernel_checks"] = {"k1_bf16_max_abs": k1_max_abs, "k2_max_abs": k2_max_abs}

    # the quality gate's round trip, served at batch 8: analysis -> scale_mel -> serve -> re-analysis
    corpus, seed, style = V2_EVAL_SETS["SPEECH"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        paths = make_corpus(os.path.join(tmp, corpus), n_utterances=8, seed=seed, style=style, quiet=True)
        sounds = [(os.path.basename(p), *read_wav(p)) for p in paths]
    rows = round_trip(inv, sounds, depth=3, batch=8)
    means = summarize(rows)
    with open(os.path.join(os.path.dirname(inv.config_file), "quality_report.json")) as f:
        registry = json.load(f)
    reg = {r["file"]: r["mel_L1_dB"] for r in registry["files"]}
    print("  mel-L1 dB per file, port / registry: " + ", ".join(f"{r['mel_L1_dB']:.3f}/{reg.get(r['file'])}"
                                                                for r in rows), flush=True)
    delta = means["mean_mel_L1_dB"] - registry["mean_mel_L1_dB"]
    check(len(rows) == 8 and abs(delta) <= 0.15,
          f"quality round trip, SPEECH bf16, {corpus} (seed {seed}, {len(rows)} files, served at batch 8, "
          f"{time.perf_counter() - t0:.1f} s): mean mel-L1 {means['mean_mel_L1_dB']:.3f} dB vs the registry's "
          f"{registry['mean_mel_L1_dB']:.3f} ({delta:+.3f}, |delta| <= 0.15); MCD {means['mean_mcd_dB']} "
          f"({registry['mean_mcd_dB']}), F0-RMSE {means['mean_f0_rmse_hz']} Hz ({registry['mean_f0_rmse_hz']}), "
          f"voicing error {means['mean_voicing_err_pct']} % ({registry['mean_voicing_err_pct']})")
    numbers["quality"] = {**means, "registry_mean_mel_L1_dB": registry["mean_mel_L1_dB"]}
    return numbers


LONG_FRAMES, LONG_CHUNK, LONG_HALO = 4800, 512, 48  # 60 s, the JAX package's long-form setting (bench.py)
LIVE_CHUNKS, LIVE_HALO, LIVE_HALO_RIGHT = (4, 8, 16, 32), 32, 2  # tools/bench_latency.py's sweep
LIVE_FRAMES = 200  # the live checks' signal: 2.5 s
SIGMA0 = dict(pp_mod_subnet_noise_channel_sigma=0, normalize_rms_from_mell=False)


def registry_variant(model_id: str, wn_dtype, dev, **overrides):
    """A registry model with config keys overridden and its shipped weights
    (`create_registry_model`), with the WaveNet/subnet compute dtype forced
    as `inverter` forces it (an empty value is fp32; None keeps bf16)."""
    from mbexwn_vocoder_torch.models import create_registry_model

    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        if wn_dtype is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = wn_dtype
    return create_registry_model(model_id, **overrides).to(dev)


@contextlib.contextmanager
def recording_k1(store: dict):
    """A context in which the model's stack calls (nn/wavenet.py's
    `wavenet_stack`) run as before and the first call of each (shape, dtype,
    causal) keeps a copy of its inputs in `store`, so that the kernel can be
    held against its plain version at the shapes a path gave it, after the
    path ran and its launch counts were read."""
    import mbexwn_vocoder_torch.nn.wavenet as wn_module

    real = wn_module.wavenet_stack

    def recording(x, cond, weights, dils, activation="gtu", causal=False):
        key = (tuple(x.shape), str(x.dtype)[6:], bool(causal))
        if key not in store:
            store[key] = (x.clone(), cond.clone(), weights, tuple(dils), activation)
        return real(x, cond, weights, dils, activation, causal=causal)

    wn_module.wavenet_stack = recording
    try:
        yield store
    finally:
        wn_module.wavenet_stack = real


def hold_k1(store: dict, plain, check, what: str):
    """K1 against `plain`, its plain version, on every input set in `store`
    (`recording_k1`), which it empties: fp32 rel-RMS <= 1e-4, bf16 <= 2e-2,
    one check line for the lot.  Returns (a row per input set, the largest
    bf16 max abs error)."""
    import torch
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack

    rows, bad = [], []
    for (shape, dtype, causal), (x, cond, weights, dils, activation) in sorted(store.items()):
        with torch.inference_mode(), exact_fp32():
            g = wavenet_stack(x, cond, weights, dils, activation, causal=causal).cpu().numpy()
            r = plain(x, cond, weights, dils, activation, causal).cpu().numpy()
        err, max_abs = rel_rms(g, r), float(np.max(np.abs(g - r)))
        rows.append({"B": shape[0], "rows": shape[1], "C": shape[2], "dtype": dtype, "causal": causal,
                     "rel_rms": err, "max_abs": max_abs})
        if not (np.isfinite(g).all() and err <= (1e-4 if dtype == "float32" else 2e-2)):
            bad.append(rows[-1])
    store.clear()
    worst = {d: max((r["rel_rms"] for r in rows if r["dtype"] == d), default=None) for d in ("float32", "bfloat16")}
    shapes = sorted({(r["B"], r["rows"]) for r in rows})
    check(bool(rows) and not bad,
          f"K1 vs plain at the {what} path's {len(rows)} stack input sets (B x rows: "
          f"{', '.join(f'{b_}x{t_}' for b_, t_ in shapes)}; C={rows[0]['C'] if rows else '-'}): worst rel-RMS "
          f"fp32 {worst['float32']} (<= 1e-4), bf16 {worst['bfloat16']} (<= 2e-2); failing {bad}")
    return rows, max((r["max_abs"] for r in rows if r["dtype"] == "bfloat16"), default=0.0)


def phase_streaming(inverter, check, dev):
    """Phase [8]: streaming, SPEECH, full width.  (a) K1's causal taps against
    the plain version; (b) long-form synth / synth_batched / synth_scan
    against one-shot, chunk by chunk, with each pass's launch counts and K1
    against its plain version at every stack shape the pass gave it, K2's
    phase across chunk boundaries and the chunk-end phase against the
    one-shot phase, then one counted pass and the audio-s/s of each mode
    with the shipped model; (c) K1 against plain at every live chunk span,
    then live causal stream(): bit-equal across slab sizes and to synth(),
    the halo_right guard, warm(), and the per-chunk latency and launches at
    chunks 4/8/16/32.  Returns the numbers for the `streaming:` line."""
    import torch
    import mbexwn_vocoder_torch.models.mbexwn as mbexwn_module
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops import wavenet_stack as ws
    from mbexwn_vocoder_torch.ops.oscillator import oscillate, oscillate_plain
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.parallel import StreamingSynthesizer

    numbers = {"k1_causal": [], "k1_long_form": [], "k1_live": [], "long_form": {}, "live": {}}
    k1_bf16_max_abs = [0.0]

    def one_shot(model, mel):
        with torch.inference_mode():
            y = model.infer(torch.from_numpy(mel).to(dev), synth_length=mel.shape[1] * model.spect_hop_size)
        return y.cpu().numpy()

    def n_stack_layers(model):
        return sum(getattr(model.block, n).wavenet.n_layers for n in model.block.block_names)

    # (a) K1 causal against its plain version on the card, on the causal models' own stack inputs
    print("  (a) K1 causal taps vs plain", flush=True)
    speech_c32 = registry_variant("SPEECH", "", dev, force_causal=True, **SIGMA0)
    voice_c32 = registry_variant("VOICE", "", dev, force_causal=True)
    live_span = LIVE_HALO + 16 + LIVE_HALO_RIGHT
    cases = [(speech_c32, "SPEECH", frames, bi, dtype) for frames in (N_FRAMES, live_span) for bi in (0, 1)
             for dtype in (torch.float32, torch.bfloat16)] + [(voice_c32, "VOICE", N_FRAMES, 0, torch.bfloat16)]
    for model, name, frames, bi, dtype in cases:
        check(getattr(model.block, model.block.block_names[bi]).wavenet.causal, f"{name} block {bi} is causal")
        x, cond, weights, dils, _ = stack_inputs(model, make_mel(frames, 80, SEED + 30), bi, dtype, dev)
        with torch.inference_mode(), exact_fp32():
            g = ws.wavenet_stack(x, cond, weights, dils, causal=True).cpu().numpy()
            r = ws.wavenet_stack_plain(x, cond, weights, dils, causal=True).cpu().numpy()
        err, max_abs = rel_rms(g, r), float(np.max(np.abs(g - r)))
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if dtype == torch.bfloat16:
            k1_bf16_max_abs[0] = max(k1_bf16_max_abs[0], max_abs)
        numbers["k1_causal"].append({"model": name, "frames": frames, "block": bi, "rows": x.shape[1], "C": x.shape[2],
                                     "dtype": str(dtype)[6:], "rel_rms": err, "max_abs": max_abs})
        check(np.isfinite(g).all() and err <= tol,
              f"K1 causal {name} block {bi} {frames} frames (rows {x.shape[1]}, C={x.shape[2]}) {str(dtype)[6:]}: "
              f"rel-RMS {err:.3e} (<= {tol:g}), max abs {max_abs:.3e}")

    # from here on the plain stack must never see a CUDA tensor: count what reaches it
    plain_on_card = [0]
    real_plain = ws.wavenet_stack_plain

    def counting_plain(x, *args, **kwargs):
        plain_on_card[0] += int(x.is_cuda)
        return real_plain(x, *args, **kwargs)

    def held(store, what, key):
        rows, max_abs = hold_k1(store, real_plain, check, what)
        numbers[key] += rows
        k1_bf16_max_abs[0] = max(k1_bf16_max_abs[0], max_abs)

    ws.wavenet_stack_plain = counting_plain
    try:
        # (b) long form at the JAX package's setting: 60 s, chunk 512, halo 48
        print(f"  (b) long form: {LONG_FRAMES} frames, chunk {LONG_CHUNK}, halo {LONG_HALO}", flush=True)
        mel_long = make_mel(LONG_FRAMES, 80, SEED + 40)
        hop, sr = speech_c32.spect_hop_size, speech_c32.sample_rate
        audio_s = LONG_FRAMES * hop / sr
        modes = ("synth", "synth_batched", "synth_scan")
        n_layers = n_stack_layers(speech_c32)

        def chunk_programs(ss, mode):
            """The chunk programs one pass of `mode` enqueues: a chunk, or a batched group, each K1 x n_layers + K2."""
            bounds = ss._bounds(LONG_FRAMES)
            if mode == "synth_batched":
                return len({(hi - lo, t0 - lo, t1 - t0) for t0, t1, lo, hi in bounds})
            return len(bounds) if mode == "synth" else -(-LONG_FRAMES // LONG_CHUNK)

        def counted(ss, mode, what, store=None):
            """One pass of `mode` with the launch counts set to 0 just before and read just after."""
            kernel_lib.reset_launch_counts()
            if store is None:
                y = getattr(ss, mode)(mel_long)
            else:
                with recording_k1(store):
                    y = getattr(ss, mode)(mel_long)
            counts = dict(kernel_lib.launches)
            n = chunk_programs(ss, mode)
            check(counts == {"wavenet_layer": n_layers * n, "oscillator": n} and np.isfinite(y).all()
                  and y.shape == (1, LONG_FRAMES * hop),
                  f"{mode} {what}: finite audio of {LONG_FRAMES * hop} samples; launches {counts} for {n} chunk "
                  f"programs (expected wavenet_layer {n_layers}, oscillator 1 each)")
            return y, counts

        for wn_dtype, label, tol in (("", "fp32", 2e-3), (None, "bf16", 2e-2)):
            model = registry_variant("SPEECH", wn_dtype, dev, **SIGMA0)
            y_one = one_shot(model, mel_long)
            ss = StreamingSynthesizer(model, chunk_frames=LONG_CHUNK, halo_frames=LONG_HALO, device=dev)
            bounds = ss._bounds(LONG_FRAMES)
            for mode in modes:
                store = {}
                y, counts = counted(ss, mode, f"{label} sigma-0", store)
                # synth_scan's edge chunks see replicated halos: its interior only
                lo_f, hi_f = (LONG_HALO, LONG_FRAMES - LONG_HALO) if mode == "synth_scan" else (0, LONG_FRAMES)
                err = rel_rms(y[:, lo_f * hop: hi_f * hop], y_one[:, lo_f * hop: hi_f * hop])
                per_chunk = [rel_rms(y[:, max(t0, lo_f) * hop: min(t1, hi_f) * hop],
                                     y_one[:, max(t0, lo_f) * hop: min(t1, hi_f) * hop]) for t0, t1, _, _ in bounds]
                numbers["long_form"].setdefault(mode, {}).update({f"rel_rms_vs_one_shot_{label}": err,
                                                                  f"rel_rms_per_chunk_{label}": per_chunk,
                                                                  f"launches_{label}": counts})
                what = (f"{mode} {label} vs one-shot infer{' (interior)' if mode == 'synth_scan' else ''}, sigma-0 "
                        f"SPEECH: rel-RMS {err:.3e}, per chunk {' '.join(f'{e:.2e}' for e in per_chunk)}")
                if label == "fp32":
                    check(max(per_chunk) <= tol, f"{what} (every chunk <= {tol:g})")
                else:  # bf16 is reported: the F0 net sums a bf16 convolution in a shape-dependent order
                    print(f"  report {what} (bound {tol:g}: {'within' if max(per_chunk) <= tol else 'BEYOND'})",
                          flush=True)
                held(store, f"{mode} {label}", "k1_long_form")
            if label == "fp32":
                # K2 inside one synth and one synth_scan pass: its phase bit-equal to the plain version's,
                # chunk by chunk, continuous across the chunk boundaries, and at each chunk's end against
                # the one-shot phase
                blk, stp, rate = model.block, ss.stp, ss.osc_rate
                wt = blk.wavetable
                with torch.inference_mode(), exact_fp32():
                    f0_one = ss._model_f0(torch.from_numpy(mel_long).to(dev))
                    phase_one = oscillate_plain(f0_one, blk.wavetables, wt.nominalF0, wt.F0GridFactor,
                                                wt.min_transposition, wt.max_transposition, wt.sample_rate,
                                                return_phase=True)[1][0].cpu().numpy()
                f0_one = f0_one[0].cpu().numpy()

                def cycles(a, b):
                    d = (float(a) - float(b)) % 1.0
                    return min(d, 1.0 - d)

                for mode in ("synth", "synth_scan"):
                    calls = []

                    def recording(f0, tables, *consts, phase_offset=None, **_):
                        audio, phase = oscillate(f0, tables, *consts, phase_offset=phase_offset, return_phase=True)
                        ref, ref_phase = oscillate_plain(f0, tables, *consts, phase_offset=phase_offset,
                                                         return_phase=True)
                        calls.append((f0.cpu().numpy(), phase.cpu().numpy(), float((audio - ref).abs().max()),
                                      int((phase != ref_phase).sum())))
                        return audio

                    mbexwn_module.oscillate = recording
                    try:
                        getattr(ss, mode)(mel_long)
                    finally:
                        mbexwn_module.oscillate = oscillate
                    # (t0, t1, the chunk's first interior sample in its span) of every chunk
                    chunks = ([(t0, t1, (t0 - lo) * stp) for t0, t1, lo, _ in bounds] if mode == "synth" else
                              [(t0, min(t0 + LONG_CHUNK, LONG_FRAMES), LONG_HALO * stp)
                               for t0 in range(0, LONG_FRAMES, LONG_CHUNK)])
                    jumps, end_gaps, f0_gaps = [], [], []
                    for k, ((t0, t1, left), (f0c, phase, _, _)) in enumerate(zip(chunks, calls)):
                        last = left + (t1 - t0) * stp - 1
                        end_gaps.append(cycles(phase[0, last], phase_one[t1 * stp - 1]))
                        f0_gaps.append(float(np.max(np.abs(f0c[0, left: last + 1] - f0_one[t0 * stp: t1 * stp]))))
                        if k + 1 < len(calls):
                            f0n, phase_n, nleft = calls[k + 1][0], calls[k + 1][1], chunks[k + 1][2]
                            jumps.append(cycles(phase_n[0, nleft] - phase[0, last], f0n[0, nleft] / rate))
                    n_diff = sum(c[3] for c in calls)
                    audio_err = max(c[2] for c in calls)
                    numbers["long_form"][mode].update(k2_phase_samples_differing=n_diff,
                                                      k2_boundary_phase_jump_max=max(jumps),
                                                      chunk_end_phase_vs_one_shot_cycles=end_gaps,
                                                      interior_f0_vs_one_shot_max_abs_hz=f0_gaps)
                    check(len(calls) == len(chunks) and n_diff == 0 and audio_err <= 1e-5 and max(jumps) <= 1e-3,
                          f"K2 in one fp32 {mode} pass ({len(calls)} chunks): phase samples differing from plain "
                          f"{n_diff}, audio max abs {audio_err:.3e} (<= 1e-5); largest phase jump at a chunk "
                          f"boundary {max(jumps):.3e} cycles (<= 1e-3)")
                    print(f"  fp32 {mode}: phase at each chunk's end vs the one-shot phase (cycles) "
                          f"{' '.join(f'{g:.2e}' for g in end_gaps)}; interior F0 vs the one-shot F0, max abs (Hz) "
                          f"{' '.join(f'{g:.2e}' for g in f0_gaps)}", flush=True)

        shipped = inverter("SPEECH", None).model
        ss = StreamingSynthesizer(shipped, chunk_frames=LONG_CHUNK, halo_frames=LONG_HALO, device=dev)
        walls = {mode: [] for mode in modes}
        for mode in modes:
            getattr(ss, mode)(mel_long)  # warm pass
        long_launches = {"wavenet_layer": 0, "oscillator": 0}
        for mode in modes:  # the long-form path as a user runs it: one counted pass per mode
            _, counts = counted(ss, mode, "shipped bf16")
            numbers["long_form"][mode]["launches"] = counts
            for k in long_launches:
                long_launches[k] += counts[k]
        numbers["long_form"]["launches"] = long_launches
        for _ in range(5):
            for mode in modes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                getattr(ss, mode)(mel_long)
                walls[mode].append(1e3 * (time.perf_counter() - t0))
        for mode in modes:
            busy_ms, n_act, _ = device_activity(lambda: getattr(ss, mode)(mel_long))
            wall = float(np.median(walls[mode]))
            nb = numbers["long_form"][mode]
            nb.update(wall_ms=wall, wall_ms_passes=walls[mode], audio_s_per_s=audio_s / (wall / 1e3),
                      device_busy_ms=busy_ms, device_activities=n_act, idle_share=max(0.0, 1.0 - busy_ms / wall))
            print(f"  {mode} (shipped SPEECH, bf16): {nb['audio_s_per_s']:.1f} audio-s/s ({wall:.1f} ms for "
                  f"{audio_s:.0f} s, median of {', '.join(f'{w:.1f}' for w in walls[mode])}); device busy "
                  f"{busy_ms:.2f} ms in {n_act} activities, idle share {nb['idle_share']:.3f}", flush=True)

        # (c) live, causal, at bench_latency's sweep
        print(f"  (c) live: causal SPEECH, halo {LIVE_HALO}, halo_right {LIVE_HALO_RIGHT}", flush=True)
        mel_live = make_mel(LIVE_FRAMES, 80, SEED + 50)
        live16 = registry_variant("SPEECH", None, dev, force_causal=True, **SIGMA0)
        for c in LIVE_CHUNKS:  # K1 against plain at every span a live stream of this chunk size gives it
            for model, label in ((speech_c32, "fp32"), (live16, "bf16")):
                store = {}
                with recording_k1(store):
                    StreamingSynthesizer(model, chunk_frames=c, halo_frames=LIVE_HALO, halo_right=LIVE_HALO_RIGHT,
                                         device=dev).synth(mel_live)
                check(all(key[2] for key in store), f"live chunk {c} {label}: every stack call is causal")
                held(store, f"live chunk {c} {label} (spans up to {LIVE_HALO + c + LIVE_HALO_RIGHT} frames)",
                     "k1_live")
        y_one = one_shot(speech_c32, mel_live)
        ss = StreamingSynthesizer(speech_c32, chunk_frames=16, halo_frames=LIVE_HALO, halo_right=LIVE_HALO_RIGHT,
                                  device=dev)
        outs = {slab: np.concatenate(list(ss.stream(mel_live[:, i:i + slab] for i in range(0, LIVE_FRAMES, slab))),
                                     axis=1) for slab in (1, 4, 7)}
        y_synth = ss.synth(mel_live)
        err = rel_rms(outs[1], y_one)
        same = all(np.array_equal(outs[1], o) for o in outs.values()) and np.array_equal(outs[1], y_synth)
        ss1 = StreamingSynthesizer(speech_c32, chunk_frames=16, halo_frames=LIVE_HALO, halo_right=1, device=dev)
        err1 = rel_rms(ss1.synth(mel_live), y_one)
        numbers["live"]["fp32_rel_rms_vs_one_shot"] = err
        numbers["live"]["fp32_rel_rms_halo_right_1"] = err1
        check(same and outs[1].shape == y_one.shape and err <= 1e-3 and err1 > 1e-3,
              f"stream() fp32, chunk 16, slabs of 1/4/7 frames bit-equal to each other and to synth(): {same}; "
              f"rel-RMS vs one-shot {err:.3e} (<= 1e-3); with halo_right=1 {err1:.3e} (> 1e-3)")
        ss = StreamingSynthesizer(speech_c32, chunk_frames=16, halo_frames=LIVE_HALO, halo_right=LIVE_HALO_RIGHT,
                                  device=dev)
        ss.warm()
        warmed = set(ss.programs)
        list(ss.stream(mel_live[:, i:i + 4] for i in range(0, LIVE_FRAMES, 4)))
        check(len(ss.programs - warmed) <= 1, f"after warm() ({len(warmed)} shapes) stream() ran "
                                              f"{len(ss.programs - warmed)} other chunk shape(s) (<= 1)")

        live_launches = {"wavenet_layer": 0, "oscillator": 0}
        for c in LIVE_CHUNKS:
            ss = StreamingSynthesizer(live16, chunk_frames=c, halo_frames=LIVE_HALO, halo_right=LIVE_HALO_RIGHT,
                                      device=dev)
            ss.warm()
            n_chunks = -(-LIVE_HALO // c) + 31
            mel = make_mel(n_chunks * c, 80, SEED + 60 + c)
            stream = ss.stream(mel[:, i:i + c] for i in range(0, n_chunks * c, c))
            latencies, chunks = [], []
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            replays0 = ss.replays
            while True:
                t0 = time.perf_counter()
                audio = next(stream, None)
                if audio is None:
                    break
                latencies.append(1e3 * (time.perf_counter() - t0))
                chunks.append(audio)
            counts = dict(kernel_lib.launches)
            check(all(a.shape == (1, c * hop) and np.isfinite(a).all() for a in chunks),
                  f"live chunk {c} bf16: {len(chunks)} finite audio chunks of {c * hop} samples")
            for k in live_launches:
                live_launches[k] += counts[k]
            steady = latencies[-31:-1]  # the last 30 chunks with the full left halo (the tail flush excluded)
            row = {"chunk_frames": c, "audio_ms": 1e3 * c * hop / sr, "lookahead_ms": 1e3 * LIVE_HALO_RIGHT * hop / sr,
                   "latency_ms_p50": float(np.median(steady)), "latency_ms_p95": float(np.percentile(steady, 95)),
                   "chunks": len(latencies), "k1_per_chunk": counts["wavenet_layer"] / len(latencies),
                   "k2_per_chunk": counts["oscillator"] / len(latencies)}
            numbers["live"][f"chunk_{c}"] = row
            replayed = ss.replays - replays0  # a replayed chunk's graph counts no kernel launch
            eager = len(latencies) - replayed
            row["replayed"] = replayed
            check(replayed == len(latencies) - 1 and
                  counts == {"wavenet_layer": n_layers * eager, "oscillator": eager},
                  f"live chunk {c} bf16: {len(latencies)} chunks, {replayed} replayed a graph (expected all but "
                  f"the tail), launches {counts} (expected per eager chunk wavenet_layer={n_layers}, oscillator=1)")
            # one steady chunk as stream() emits it (upload, chunk program, readback) under the profiler
            span = mel[:, : LIVE_HALO + c + LIVE_HALO_RIGHT]
            carry = torch.zeros((1,), dtype=torch.float64, device=dev)
            busy_ms, n_act, _ = device_activity(lambda: ss._chunk(ss._to_device(span), carry, LIVE_HALO, c)[0].cpu())
            row.update(device_busy_ms=busy_ms, device_activities=n_act,
                       idle_share=max(0.0, 1.0 - busy_ms / row["latency_ms_p50"]))
            print(f"  live chunk {c} frames ({row['audio_ms']:.1f} ms of audio, +{row['lookahead_ms']:.1f} ms "
                  f"lookahead): latency host call -> audio on host median {row['latency_ms_p50']:.2f} ms, p95 "
                  f"{row['latency_ms_p95']:.2f} ms (30 steady chunks); one chunk busies the card {busy_ms:.3f} ms "
                  f"in {n_act} device activities, idle share {row['idle_share']:.3f}", flush=True)
    finally:
        ws.wavenet_stack_plain = real_plain
    numbers["live"]["launches"] = live_launches
    numbers["k1_bf16_max_abs"] = k1_bf16_max_abs[0]
    check(plain_on_card[0] == 0, f"the plain stack was called on a CUDA tensor {plain_on_card[0]} times in [8](b)-(c)")
    return numbers


TRAIN_SEGMENT, TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TIMED = 24_000, 32, 20, 2, 10


def training_batch(preprocess_config, batch: int, seed: int):
    """`batch` segments of synthetic speech (synth_utterance, one seeded
    generator) with their log-mel from the port's analysis front end and
    their F0 contour at the sample rate."""
    from mbexwn_vocoder_torch.analysis import compute_mel_spectrogram_internal
    from mbexwn_vocoder_torch.training.synthetic import synth_utterance

    rng = np.random.RandomState(seed)
    sr = preprocess_config["sample_rate"]
    audio, f0, mel = [], [], []
    for _ in range(batch):
        a, f = synth_utterance(rng, duration_s=TRAIN_SEGMENT / sr, sr=sr)
        a, f = a[:TRAIN_SEGMENT], f[:TRAIN_SEGMENT]
        mell, _ = compute_mel_spectrogram_internal(a[None], preprocess_config=preprocess_config, do_post=True)
        audio.append(a)
        f0.append(f)
        mel.append(mell[0])
    return {"audio": np.stack(audio).astype(np.float32), "mel": np.stack(mel).astype(np.float32),
            "F0": np.stack(f0).astype(np.float32)}


def phase_training(check, dev):
    """Phase [9]: the training step on the card.  (a) the kernels' refusal
    under grad; (b) the tiny configuration's loss and gradients on the card
    against the CPU's; (c) full-width SPEECH: 20 steps on one batch, step
    time, peak memory and idle share; (d) the trained model exported and
    synthesised through the kernels.  Returns the numbers for the
    `training:` line."""
    import tempfile

    import torch
    import yaml
    from mbexwn_vocoder_torch import get_config_file
    from mbexwn_vocoder_torch.compat.params_io import params_to_jax, save_params
    from mbexwn_vocoder_torch.config import read_config
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.models import create_registry_model
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops.oscillator import oscillate
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack
    from mbexwn_vocoder_torch.training.parity import card_against_cpu
    from mbexwn_vocoder_torch.training.trainer import Trainer

    numbers = {}
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):  # (b) in fp32, then (c) as shipped: bf16
        os.environ[var] = ""

    # (a) the kernels refuse grad: they have no backward pass
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((1, 256, 320), generator=g, device=dev, requires_grad=True)
    cond = torch.randn((1, 256, 640), generator=g, device=dev)
    weights = [(torch.randn((640, 3, 320), generator=g, device=dev) * 0.03, torch.zeros(640, device=dev),
                torch.randn((320, 320), generator=g, device=dev) * 0.05, torch.zeros(320, device=dev))]
    f0 = torch.full((1, 12_000), 150.0, device=dev, requires_grad=True)
    tables = torch.rand((513, 13), generator=g, device=dev)
    refused = []
    for name, call in (("K1 wavenet_layer", lambda: wavenet_stack(x, cond, weights, [1])),
                       ("K2 oscillator", lambda: oscillate(f0, tables, 50.0, 1.25, 1.0, 13.0, 12_000.0))):
        try:
            call()
            refused.append(f"{name}: ran")
        except RuntimeError as e:
            refused.append(f"{name}: {'raised' if 'no backward pass' in str(e) else 'other error: ' + str(e)}")
    check(all(r.endswith("raised") for r in refused),
          f"(a) under grad, on CUDA inputs that require grad: {'; '.join(refused)}")

    # (b) the tiny case on the card against the CPU: fp64 tight, fp32 loss, fp32 gradients reported
    tiny_failures, tiny = card_against_cpu(dev, SEED)
    numbers["tiny_card_vs_cpu"] = tiny
    check(not tiny_failures,
          f"(b) tiny case, card vs CPU, {tiny['leaves']} gradient leaves: fp64 loss rel {tiny['loss_fp64_rel']:.1e} "
          f"(<= 1e-12), worst leaf {tiny['worst_leaf_fp64']} {tiny['worst_rel_rms_fp64']:.1e} (<= 1e-9); fp32 loss "
          f"{tiny['loss_fp32']:.7g} vs {tiny['loss_fp32_cpu']:.7g} (rel {tiny['loss_fp32_rel']:.1e} <= 1e-5); fp32 "
          f"gradients against the CPU's fp64 (reported): card worst {tiny['fp32_vs_exact_worst_leaf']} "
          f"{tiny['fp32_vs_exact_worst_rel_rms']:.2e}, CPU worst {tiny['fp32_vs_exact_worst_leaf_cpu']} "
          f"{tiny['fp32_vs_exact_worst_rel_rms_cpu']:.2e}; failing {tiny_failures}")

    # (c) full width: SPEECH as shipped, bf16, from its weights in the trainable form
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        os.environ.pop(var, None)
    hp = read_config(get_config_file("SPEECH"))
    model = create_registry_model("SPEECH", trainable=True)
    blk = model.block
    check(blk.wn_compute_dtype == torch.bfloat16 and blk.subnet_compute_dtype == torch.bfloat16,
          "(c) SPEECH's compute dtypes are the shipped bf16")
    t0 = time.perf_counter()
    batch = training_batch(hp["preprocess_config"], hp["training_config"]["train_batch_size"], SEED + 90)
    B = batch["audio"].shape[0]
    print(f"  (c) batch of {B} x {batch['audio'].shape[1]} samples ({batch['mel'].shape[1]} mel frames) from "
          f"synth_utterance, {time.perf_counter() - t0:.1f} s", flush=True)
    tr = Trainer(model, hp, device=dev)
    cut = None
    while True:
        try:
            torch.cuda.reset_peak_memory_stats()
            metrics = tr.train_step({k: v[:B] for k, v in batch.items()})  # the first warm-up step
            break
        except torch.cuda.OutOfMemoryError:
            cut = f"batch {B} ran out of device memory"
            B //= 2
            tr.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            if B == 0:
                raise
    if cut:
        print(f"  (c) CUT: {cut}; the phase runs at batch {B}, the largest that fits", flush=True)
    batch = {k: v[:B] for k, v in batch.items()}
    losses, event_ms, host_ms = [float(metrics["total_loss"])], [], []
    for step in range(1, TRAIN_STEPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        metrics = tr.train_step(batch)
        stop.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        event_ms.append(start.elapsed_time(stop))
        losses.append(float(metrics["total_loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = slice(TRAIN_WARMUP - 1, TRAIN_WARMUP - 1 + TRAIN_TIMED)  # the first step ran above
    step_event_ms, step_host_ms = float(np.median(event_ms[timed])), float(np.median(host_ms[timed]))
    busy_ms, n_act, by_name = device_activity(lambda: tr.train_step(batch))
    T_wn = [tr.model.block.wn_input_length(batch["mel"].shape[1]) * (2 if i else 1) for i in range(2)]
    C = getattr(blk, blk.block_names[0]).wavenet.n_channels
    flop = sum(3 * k1_work(B, t, C, getattr(blk, name).wavenet.n_layers)[0] for t, name in zip(T_wn, blk.block_names))
    bound_ms = 1e3 * flop / H100_BF16_FLOPS
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    numbers["full_width"] = {
        "model": "SPEECH", "batch": B, "cut": cut, "segment_samples": TRAIN_SEGMENT,
        "mel_frames": int(batch["mel"].shape[1]), "losses": losses, "step_ms_cuda_events": step_event_ms,
        "step_ms_host": step_host_ms, "step_ms_events_all": event_ms, "step_ms_host_all": host_ms,
        "wavenet_fwd_bwd_tflop": flop / 1e12, "wavenet_bound_ms": bound_ms, "peak_memory_gb": peak_gb,
        "device_busy_ms_one_step": busy_ms, "device_activities_one_step": n_act,
        "idle_share": max(0.0, 1.0 - busy_ms / step_host_ms)}
    print(f"  (c) losses per step: {' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    print(f"  (c) step {step_event_ms:.2f} ms (CUDA events) / {step_host_ms:.2f} ms (host clock), median of "
          f"{TRAIN_TIMED} after {TRAIN_WARMUP} warm-up; WaveNet forward + backward bound {bound_ms:.2f} ms "
          f"({flop / 1e12:.2f} TFLOP at 989 TFLOP/s bf16); peak memory {peak_gb:.2f} GB; one step busies the card "
          f"{busy_ms:.2f} ms in {n_act} device activities, idle share {numbers['full_width']['idle_share']:.3f}",
          flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:9.3f} ms {n:5d}x  {name[:80]}", flush=True)
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"(c) SPEECH full width, batch {B}: {TRAIN_STEPS} steps on one batch, every loss finite; the loss falls "
          f"(mean of the first 5 {first:.4f} -> mean of the last 5 {last:.4f})")

    # (d) fold: the trained model itself synthesises through the kernels; then export, reload in
    # MELInverter and synthesise through the kernels
    tr.model.fold_()
    mel = make_mel(N_FRAMES, 80, SEED)
    mel_t = torch.from_numpy(mel).to(dev)
    with torch.inference_mode():
        tr.model.infer(mel_t, N_FRAMES * blk.spect_hop_size)  # warm-up
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
        y = tr.model.infer(mel_t, N_FRAMES * blk.spect_hop_size)
        counts = dict(kernel_lib.launches)
        y = y.float().cpu().numpy()[0]
    numbers["trained_synthesis_launches"] = counts
    check(y.shape == (N_FRAMES * blk.spect_hop_size,) and bool(np.isfinite(y).all())
          and counts == {"wavenet_layer": 24, "oscillator": 1},
          f"(d) the trained model after fold_(), on the card: {N_FRAMES}-frame synthesis finite ({y.shape[0]} "
          f"samples), launches {counts} (24 K1 + 1 K2)")
    with tempfile.TemporaryDirectory() as tmp:
        save_params(os.path.join(tmp, "weights.npz"), params_to_jax(tr.model.block.state_dict()))
        with open(os.path.join(tmp, "config.yaml"), "w") as f:
            yaml.safe_dump(json.loads(json.dumps(hp, default=lambda o: f"np.{o.__name__}" if isinstance(o, type)
                                                 else float(o))), f)
        inv = MELInverter(tmp, device=dev)
    inv.synth_from_mel(mel)  # warm-up
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
    y = inv.synth_from_mel(mel)
    counts = dict(kernel_lib.launches)
    numbers["reloaded_synthesis_launches"] = counts
    check(y.shape == (N_FRAMES * inv.hop_size,) and bool(np.isfinite(y).all())
          and counts == {"wavenet_layer": 24, "oscillator": 1},
          f"(d) the trained model folded, saved (save_params) and loaded by MELInverter on the card: "
          f"{N_FRAMES}-frame synthesis finite ({y.shape[0]} samples), launches {counts} (24 K1 + 1 K2)")
    return numbers


CLI_MODEL = "SPEECH"  # a registry id or a model directory
CLI_STEPS, CLI_SAVE_EVERY, CLI_RESUME_TO, CLI_UTTERANCES = 10, 5, 15, 16
PRETRAIN_ITERS, GAN_STEPS = 5, 5


def hold_export_kernels(out: str, check, dev, what: str):
    """A training run's export loaded by MELInverter on the card: a 512-frame
    synthesis through 24 K1 + 1 K2 (counts set to 0 just before, read just
    after), then K1 on its two stacks (fp32 <= 1e-4, bf16 <= 2e-2 rel-RMS)
    and K2 on its F0 (audio <= 1e-5, phase bit-equal) against their plain
    versions.  Returns (the synthesis's launches, {stack: rel-RMS and max
    abs}, K2's max abs)."""
    import torch
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops.oscillator import oscillate, oscillate_plain
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain

    inv = MELInverter(out, device=dev)
    mel = make_mel(N_FRAMES, 80, SEED)
    inv.synth_from_mel(mel)  # warm-up
    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
    y = inv.synth_from_mel(mel)
    counts = dict(kernel_lib.launches)
    check(y.shape == (N_FRAMES * inv.hop_size,) and bool(np.isfinite(y).all())
          and counts == {"wavenet_layer": 24, "oscillator": 1},
          f"{what} the export loaded by MELInverter on the card: {N_FRAMES}-frame synthesis finite ({y.shape[0]} "
          f"samples), launches {counts} (24 K1 + 1 K2)")
    k1_err = {}
    for block_index in range(len(inv.model.block.block_names)):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x, cond, weights, dils, f0 = stack_inputs(inv.model, mel, block_index, dtype, dev)
            with torch.inference_mode(), exact_fp32():
                got = wavenet_stack(x, cond, weights, dils).float().cpu().numpy()
                ref = wavenet_stack_plain(x, cond, weights, dils).float().cpu().numpy()
            err = rel_rms(got, ref)
            k1_err[f"block{block_index} {str(dtype)[6:]}"] = {"rel_rms": err,
                                                              "max_abs": float(np.max(np.abs(got - ref)))}
            check(np.isfinite(got).all() and err <= tol,
                  f"{what} K1 on the export's block {block_index} ({x.shape[1]} rows, C={x.shape[2]}) "
                  f"{str(dtype)[6:]}: rel-RMS {err:.3e} (<= {tol:g})")
    blk, wt = inv.model.block, inv.model.block.wavetable
    consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition, wt.sample_rate)
    with torch.inference_mode():
        audio, phase = oscillate(f0, blk.wavetables, *consts, return_phase=True)
        ref_audio, ref_phase = oscillate_plain(f0, blk.wavetables, *consts, return_phase=True)
    k2_err, n_diff = float((audio - ref_audio).abs().max()), int((phase != ref_phase).sum())
    check(math.isfinite(k2_err) and k2_err <= 1e-5 and n_diff == 0,
          f"{what} K2 on the export's F0 ({f0.shape[1]} samples): audio max abs {k2_err:.3e} (<= 1e-5), phase "
          f"samples differing from plain {n_diff}")
    return counts, k1_err, k2_err


def phase_training_cli(check, dev, train_step_ms: float):
    """Phase [10]: the training CLI on the card, SPEECH at full width,
    shipped bf16.  (a) the CLI: 10 steps from the registry weights
    (--init_from), then resumed to 15; metrics, checkpoints, a bit-exact
    restore, the no-op replay, and the export synthesised through both
    kernels, each held against its plain version; (b) activation
    pretraining; (c) adversarial steps, and the tiny GAN step card vs CPU.
    Returns the numbers for the `training_driver:` line."""
    import io
    import shutil
    import tempfile
    from contextlib import redirect_stderr
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    import mbexwn_vocoder_torch.cli.train as train_cli
    import mbexwn_vocoder_torch.models.factory as factory
    from mbexwn_vocoder_torch import get_config_file
    from mbexwn_vocoder_torch.config import read_config
    from mbexwn_vocoder_torch.models import create_model, create_registry_model
    from mbexwn_vocoder_torch.observability import MetricsLogger
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.training.adversarial import AdversarialTrainer
    from mbexwn_vocoder_torch.training.checkpointing import CheckpointManager
    from mbexwn_vocoder_torch.training.data import SegmentDataset
    from mbexwn_vocoder_torch.training.parity import gan_card_against_cpu
    from mbexwn_vocoder_torch.training.pretrain import (activation_stats_loss, pretrain_activations,
                                                        pretrainable_mask)
    from mbexwn_vocoder_torch.training.synthetic import make_corpus
    from mbexwn_vocoder_torch.training.trainer import Trainer

    # SPEECH as shipped (bf16); the CLI on its default device, the card
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE", "MBEXWN_PLATFORM"):
        os.environ.pop(var, None)
    numbers = {}
    hp = read_config(get_config_file(CLI_MODEL))
    pc, B = hp["preprocess_config"], hp["training_config"]["train_batch_size"]
    registry_weights = os.path.join(os.path.dirname(get_config_file(CLI_MODEL)), "weights.npz")
    tmp = tempfile.mkdtemp(prefix="mbexwn_train_")  # outside the repo
    try:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        t0 = time.perf_counter()
        make_corpus(data, n_utterances=CLI_UTTERANCES, seed=0, quiet=True)
        print(f"  corpus: {CLI_UTTERANCES} synthetic utterances (make_corpus, seed 0), "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cli_args = dict(save_every=CLI_SAVE_EVERY, log_every=1, num_workers=2, init_from=registry_weights)

        # (a) leg 1: 10 steps warm-started from the registry weights; the
        # profiler traces the card only (the host's ops unrecorded, so the
        # host keeps its pace) from the start of step 6's train_step (after
        # step 5's checkpoint) to the sync of step 10's metrics (log_every
        # 1).  Leg 2: resumed to 15 (the checkpoint wins over --init_from).
        prof = profile(activities=[ProfilerActivity.CUDA])
        trainers, window = [], {}
        train_step, log = Trainer.train_step, MetricsLogger.log

        def traced_step(self, batch, draws=None):
            if self not in trainers:
                trainers.append(self)
            if self.step == CLI_SAVE_EVERY and "start" not in window:
                window["start"] = time.perf_counter()
                prof.start()
            return train_step(self, batch, draws)

        def traced_log(self, step, metrics):
            log(self, step, metrics)
            if step == CLI_STEPS and "end" not in window:
                torch.cuda.synchronize()
                window["end"] = time.perf_counter()
                prof.stop()  # collects the trace: its time is taken out of step 10's below
                window["stop_s"] = time.perf_counter() - window["end"]

        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(Trainer, "train_step", traced_step), mock.patch.object(MetricsLogger, "log", traced_log):
            leg1 = train_cli.main(CLI_MODEL, data, out, steps=CLI_STEPS, **cli_args)
            leg1["step_host_s"][CLI_STEPS] -= window["stop_s"]
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            leg2 = train_cli.main(CLI_MODEL, data, out, steps=CLI_RESUME_TO, **cli_args)
        busy_ms, n_act, by_name = device_busy(prof)
        window_ms = 1e3 * (window["end"] - window["start"])
        trainer = trainers[-1]  # leg 2's, at step 15

        recs = [json.loads(line) for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
        check([r["step"] for r in recs] == list(range(1, CLI_RESUME_TO + 1))
              and all(math.isfinite(v) for r in recs for v in r.values()),
              f"(a) metrics.jsonl: steps {[r['step'] for r in recs]}, every value finite")
        check(leg1["device"].startswith("cuda") and leg2["device"].startswith("cuda"),
              f"(a) the CLI trained on its default device: {leg1['device']}, {leg2['device']}")
        check(leg1["warm_started"] and leg1["start_step"] == 0 and leg2["resumed"] and leg2["start_step"] == 10
              and leg2["end_step"] == CLI_RESUME_TO,
              f"(a) leg 1 warm-started from the registry weights (0 -> {leg1['end_step']}); leg 2 resumed from its "
              f"checkpoint {leg2['start_step']} -> {leg2['end_step']} (the checkpoint wins over --init_from)")
        ckpt = CheckpointManager(os.path.join(out, "checkpoints"))
        check(ckpt.steps() == [5, 10, 15], f"(a) checkpoint directories {ckpt.steps()} (5, 10, 15)")

        # a restored state equals the saved one, bit for bit, on the card
        model, _ = create_model(hp, hp["training_config"], pc, trainable=True)
        model.init(torch.Generator().manual_seed(1))
        restored = Trainer(model, hp, device=dev)
        ckpt.restore(restored)
        same_params = all(torch.equal(v, restored.model.block.state_dict()[k])
                          for k, v in trainer.model.block.state_dict().items())
        ref_opt, got_opt = trainer.optimizer.state_dict(), restored.optimizer.state_dict()
        same_moments = ref_opt["state"].keys() == got_opt["state"].keys() and all(
            torch.equal(v, got_opt["state"][i][name].to(v.device)) for i, s in ref_opt["state"].items()
            for name, v in s.items())
        n_moments = sum(len(s) for s in ref_opt["state"].values())
        sched = {k: v for k, v in restored.scheduler.state_dict().items() if k != "lr_lambdas"}
        check(same_params and same_moments and restored.step == trainer.step == CLI_RESUME_TO
              and sched == {k: v for k, v in trainer.scheduler.state_dict().items() if k != "lr_lambdas"}
              and restored.scheduler.last_epoch == CLI_RESUME_TO
              and next(iter(restored.model.parameters())).device.type == torch.device(dev).type,
              f"(a) the step-15 checkpoint restored on the card equals the trained state bit for bit: "
              f"{len(trainer.model.block.state_dict())} parameters, {n_moments} Adam state tensors (moments and "
              f"counts), scheduler count {restored.scheduler.last_epoch}, step {restored.step}")
        del restored, model

        # the replay of a reached target: a no-op that builds no model, unless --init_from is given
        built = []
        real_create = factory.create_model

        def counting_create(*a, **k):
            built.append(1)
            return real_create(*a, **k)

        replays = {}
        for label, kw in (("plain", dict(cli_args, init_from=None)), ("init_from", cli_args)):
            built.clear()
            buf = io.StringIO()
            with mock.patch.object(factory, "create_model", counting_create), redirect_stderr(buf):
                result = train_cli.main(CLI_MODEL, data, out, steps=CLI_RESUME_TO, **kw)
            replays[label] = (result, len(built), buf.getvalue())
        (r_plain, n_plain, err_plain), (r_init, n_init, err_init) = replays["plain"], replays["init_from"]
        check(r_plain is None and n_plain == 0 and "nothing to train" in err_plain,
              f"(a) replaying --steps {CLI_RESUME_TO}: 'nothing to train', {n_plain} models built")
        check(r_init is not None and n_init == 1 and "nothing to train" not in err_init
              and r_init["end_step"] == CLI_RESUME_TO and not r_init["step_host_s"],
              f"(a) the same replay with --init_from: not skipped ({n_init} model built, resumed at step "
              f"{r_init and r_init['start_step']}, no step run, exported again)")

        # the export: MELInverter on the card, 512 frames through 24 K1 + 1 K2, each held against its plain version
        counts, k1_err, k2_err = hold_export_kernels(out, check, dev, "(a)")

        steps_ms = [1e3 * leg1["step_host_s"][k] for k in range(3, CLI_STEPS + 1)]
        loader = leg1["loader"]
        saves = leg1["checkpoints"] + leg2["checkpoints"]
        numbers["cli"] = {
            "model": CLI_MODEL, "batch": B, "segment_samples": pc["segment_length"], "steps": CLI_RESUME_TO,
            "data_source": loader["source"], "step_ms_host_median_3_10": float(np.median(steps_ms)),
            "step_ms_host_3_10": steps_ms, "phase9_step_ms_cuda_events": train_step_ms,
            "resumed_leg_step_ms_host": [1e3 * leg2["step_host_s"][k] for k in sorted(leg2["step_host_s"])],
            "time_to_first_step_s": leg1["time_to_first_step_s"],
            "profiled_window_ms": window_ms, "profiled_steps": f"{CLI_SAVE_EVERY + 1}-{CLI_STEPS}",
            "profiler_stop_ms_out_of_step_10": 1e3 * window["stop_s"],
            "device_busy_ms": busy_ms, "device_activities": n_act,
            "idle_share": max(0.0, 1.0 - busy_ms / window_ms),
            "busy_ms_per_step": busy_ms / (CLI_STEPS - CLI_SAVE_EVERY),
            "loader_ms_per_batch_per_worker_median": loader["ms_per_batch_per_worker_median"],
            "loader_workers": loader["workers"], "loader_batches_made": loader["batches_made"],
            "queue_depth_at_take_mean": loader["queue_depth_at_take_mean"],
            "queue_depth_at_take_min": loader["queue_depth_at_take_min"], "queue_capacity": loader["queue_capacity"],
            "checkpoint_saves": saves, "peak_memory_gb_leg1": peak_gb, "synthesis_launches": counts,
            "k1_vs_plain": k1_err, "k2_vs_plain_max_abs": k2_err}
        c = numbers["cli"]
        print(f"  (a) data: {c['data_source']} path; loader {c['loader_ms_per_batch_per_worker_median']:.1f} ms a "
              f"batch of {B} per worker ({c['loader_workers']} workers, {c['loader_batches_made']} batches made), "
              f"queue depth at each take mean {c['queue_depth_at_take_mean']:.2f} min {c['queue_depth_at_take_min']} "
              f"of {c['queue_capacity']}", flush=True)
        print(f"  (a) CLI step {c['step_ms_host_median_3_10']:.2f} ms (host clock, median of steps 3-10, data wait "
              f"and metric sync included) beside [9](c)'s step {train_step_ms:.2f} ms (CUDA events, fixed batch); "
              f"time to the first step {c['time_to_first_step_s']:.2f} s; peak memory {peak_gb:.2f} GB", flush=True)
        print(f"  (a) steps {c['profiled_steps']} under torch.profiler (device trace only): {window_ms:.2f} ms, the card "
              f"busy {busy_ms:.2f} ms ({c['busy_ms_per_step']:.2f} a step) in {n_act} device activities, idle share "
              f"{c['idle_share']:.3f}", flush=True)
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"    {ms:9.3f} ms {n:5d}x  {name[:80]}", flush=True)
        print("  (a) checkpoint saves: " + ", ".join(f"step {s['step']} {s['ms']:.1f} ms {s['bytes'] / 1e6:.1f} MB"
                                                  for s in saves), flush=True)
        del trainer, trainers
        torch.cuda.empty_cache()

        # (b) activation pretraining from a fresh init, two calibration batches of 32 mels
        ds = SegmentDataset(data, pc, seed=3)
        try:
            cal = [ds.batch(B)["mel"] for _ in range(2)]
        finally:
            ds.close()
        model, _ = create_model(hp, hp["training_config"], pc, trainable=True)
        model.init(torch.Generator().manual_seed(SEED))
        model.to(dev)
        start = {k: v.clone() for k, v in model.block.state_dict().items()}
        model.set_differentiable(True)
        with torch.no_grad(), exact_fp32():
            first = float(activation_stats_loss(model, torch.from_numpy(cal[0]).to(dev), 1.0,
                                                generator=torch.Generator(device=dev).manual_seed(0))[0])
        model.set_differentiable(False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        last = pretrain_activations(model, cal, target=1.0, max_iters=PRETRAIN_ITERS, lr=1e-2, to_rmse=0.0)
        torch.cuda.synchronize()
        it_ms = 1e3 * (time.perf_counter() - t0) / PRETRAIN_ITERS
        pre_peak = torch.cuda.max_memory_allocated() / 1e9
        mask = pretrainable_mask(model)
        got = model.block.state_dict()
        frozen = [k for k in got if not mask.get(k, False)]
        moved = sum(not torch.equal(got[k], start[k]) for k in got if mask.get(k, False))
        numbers["pretrain"] = {"iters": PRETRAIN_ITERS, "first_loss": first, "last_loss": last, "ms_per_iter": it_ms,
                               "peak_memory_gb": pre_peak, "frozen_leaves": len(frozen), "moved_leaves": moved}
        check(math.isfinite(first) and math.isfinite(last) and last < first
              and all(torch.equal(got[k], start[k]) for k in frozen) and moved > 0,
              f"(b) pretraining, SPEECH full width, fresh init, 2 calibration batches of {B}: stats loss {first:.4f} "
              f"-> {last:.4f} after {PRETRAIN_ITERS} iterations; {len(frozen)} frozen leaves bit-equal, {moved} "
              f"pretrainable leaves moved; {it_ms:.1f} ms an iteration, peak memory {pre_peak:.2f} GB")
        check(not any(m.differentiable for m in model.modules() if hasattr(m, "differentiable")),
              "(b) the model is back on the kernels' route after pretraining")
        del model
        torch.cuda.empty_cache()

        # (c) adversarial steps from the shipped weights, the default wavegan_config
        ds = SegmentDataset(data, pc, seed=4)
        try:
            batch = ds.batch(B)
        finally:
            ds.close()
        hp_gan = dict(hp, wavegan_config={})
        gan = AdversarialTrainer(create_registry_model(CLI_MODEL, trainable=True), hp_gan, device=dev, seed=SEED)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        torch.cuda.reset_peak_memory_stats()
        gan_ms, gan_metrics = [], []
        for _ in range(GAN_STEPS):
            start_ev, stop_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start_ev.record()
            m = gan.train_step(batch)
            stop_ev.record()
            torch.cuda.synchronize()
            gan_ms.append(start_ev.elapsed_time(stop_ev))
            gan_metrics.append({k: float(v) for k, v in m.items()})
        gan_peak = torch.cuda.max_memory_allocated() / 1e9
        keys = ("disc_loss", "adv_loss", "fm_loss", "total_loss")
        numbers["adversarial"] = {"batch": B, "steps": GAN_STEPS, "step_ms_cuda_events": gan_ms,
                                  "step_ms_median_2_5": float(np.median(gan_ms[1:])), "peak_memory_gb": gan_peak,
                                  "metrics": gan_metrics,
                                  "discriminator_params": sum(p.numel() for p in gan.discriminator.parameters())}
        check(all(math.isfinite(m[k]) for m in gan_metrics for k in keys),
              f"(c) AdversarialTrainer, SPEECH from its weights, batch {B}, default wavegan_config: {GAN_STEPS} "
              f"steps, " + "; ".join(f"{k} " + " ".join(f"{m[k]:.4f}" for m in gan_metrics) for k in keys)
              + f"; step {numbers['adversarial']['step_ms_median_2_5']:.2f} ms (CUDA events, median of steps 2-5), "
              f"peak memory {gan_peak:.2f} GB")
        del gan, batch
        torch.cuda.empty_cache()
        for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):  # the tiny case in fp64: no bf16 compute
            os.environ[var] = ""
        gan_failures, gan_tiny = gan_card_against_cpu(dev, SEED)
        numbers["adversarial_tiny_card_vs_cpu"] = gan_tiny
        check(not gan_failures,
              f"(c) tiny GAN step, card vs CPU, fp64, {gan_tiny['leaves']} gradient leaves: worst metric "
              f"{gan_tiny['worst_metric']} rel {gan_tiny['worst_metric_rel']:.1e} (<= 1e-12), worst leaf "
              f"{gan_tiny['worst_leaf']} {gan_tiny['worst_leaf_rel_rms']:.1e} (<= 1e-9); failing {gan_failures}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return numbers


DP_STEPS, DP_WARMUP = 10, 2  # [11](b): steps, of which the first DP_WARMUP are not timed
DP_CLI_STEPS = 5  # [11](c)


@contextlib.contextmanager
def launches_by_device(store: dict):
    """A context in which each kernel launch is also counted under the
    device of its tensors: store[(kernel, device)] += launches."""
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops import oscillator as osc_module
    from mbexwn_vocoder_torch.ops import wavenet_stack as ws

    real = {"wavenet_layer": (ws, "_wavenet_stack_cuda"), "oscillator": (osc_module, "_oscillate_cuda")}

    def counting(name, fn):
        def wrapped(x, *args, **kwargs):
            before = kernel_lib.launches[name]
            out = fn(x, *args, **kwargs)
            key = (name, str(x.device))
            store[key] = store.get(key, 0) + kernel_lib.launches[name] - before
            return out
        return wrapped

    saved = {name: getattr(mod, attr) for name, (mod, attr) in real.items()}
    for name, (mod, attr) in real.items():
        setattr(mod, attr, counting(name, saved[name]))
    try:
        yield store
    finally:
        for name, (mod, attr) in real.items():
            setattr(mod, attr, saved[name])


def _nccl_rank(rank: int, world: int, master: str, batch: dict, results) -> None:
    """[11](b), one rank (a spawned process): SPEECH as shipped from its
    weights, bf16, over NCCL, DP_STEPS steps on the rank's rows of `batch`
    with the trainer's own draws (seed 0, as [9](c)); puts (rank, numbers)
    or (rank, the traceback)."""
    import traceback

    try:
        import torch
        import torch.distributed as dist
        from mbexwn_vocoder_torch import get_config_file
        from mbexwn_vocoder_torch.config import read_config
        from mbexwn_vocoder_torch.models import create_registry_model
        from mbexwn_vocoder_torch.parallel import multihost
        from mbexwn_vocoder_torch.training.trainer import Trainer

        multihost.initialize(master, world_size=world, rank=rank, device=f"cuda:{rank}")
        try:
            dev = torch.device("cuda", rank)
            hp = read_config(get_config_file("SPEECH"))
            tr = Trainer(create_registry_model("SPEECH", trainable=True), hp, device=dev, group=dist.group.WORLD)
            n = batch["audio"].shape[0] // world
            rows = {k: v[rank * n: (rank + 1) * n] for k, v in batch.items()}
            syncs, sync = [], tr.sync_gradients

            def timed_sync(params):
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                sync(params)
                stop.record()
                syncs.append((start, stop))

            tr.sync_gradients = timed_sync
            torch.cuda.reset_peak_memory_stats(dev)
            losses, step_ms = [], []
            for _ in range(DP_STEPS):
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                metrics = tr.train_step(rows)
                stop.record()
                torch.cuda.synchronize(dev)
                step_ms.append(start.elapsed_time(stop))
                losses.append(float(metrics["total_loss"]))
            results.put((rank, {"losses": losses, "step_ms": step_ms,
                                "sync_ms": [a.elapsed_time(b) for a, b in syncs],
                                "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                                "backend": dist.get_backend(), "device": str(dev)}))
        finally:
            multihost.shutdown()
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def phase_parallel(inverter, check, dev, serving, streaming, training, cli_run):
    """Phase [11]: the parallel layer on the card.  (a) the tiny fp64 case
    on two gloo ranks sharing the card against the one-process step (plain
    and adversarial); (b) SPEECH as shipped at batch 32 over NCCL, one rank
    per card; (c) the training CLI with --n_devices 0; (d) BatchSynthesizer
    and synth_batched over a mesh against mesh=None.  Returns the numbers
    for the `parallel:` line."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile

    import torch
    import mbexwn_vocoder_torch.cli.train as train_cli
    from mbexwn_vocoder_torch import get_config_file
    from mbexwn_vocoder_torch.config import read_config
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack_plain
    from mbexwn_vocoder_torch.parallel import BatchSynthesizer, StreamingSynthesizer
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh
    from mbexwn_vocoder_torch.parallel.multihost import free_port
    from mbexwn_vocoder_torch.training.parity import dp_against_single
    from mbexwn_vocoder_torch.training.synthetic import make_corpus

    numbers = {"cards": torch.cuda.device_count()}
    launches = {"wavenet_layer": 0, "oscillator": 0}
    torch.cuda.empty_cache()

    # (a) two gloo ranks on one card, the tiny case in fp64
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        os.environ[var] = ""
    t0 = time.perf_counter()
    failures, tiny = dp_against_single(dev, world=2, seed=SEED, naive=False)  # the CPU tests show DDP's rule off
    numbers["tiny_dp_vs_one_process"] = dict(tiny, seconds=time.perf_counter() - t0)
    for what in ("step", "GAN step"):
        n = tiny[what]
        check(not [f for f in failures if f.startswith(what + " ")],
              f"(a) 2 gloo ranks on {dev}, tiny case fp64, global batch {tiny['global_batch']} (voiced samples per "
              f"shard {tiny['voiced_samples_per_shard']}), one {what} against the one-process step: worst metric "
              f"{n['worst_metric']} rel {n['worst_metric_rel']:.1e} (<= 1e-12), worst of {n['leaves']} gradient "
              f"leaves and updated parameters {n['worst_leaf']} {n['worst_leaf_rel_rms']:.1e} (<= 1e-9)")
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE", "MBEXWN_PLATFORM"):  # (b)-(d) as shipped: bf16
        os.environ.pop(var, None)

    # (b) NCCL, one rank per card, SPEECH as shipped at [9](c)'s batch and draws
    world = torch.cuda.device_count()
    hp = read_config(get_config_file("SPEECH"))
    fw = training["full_width"]
    batch = training_batch(hp["preprocess_config"], fw["batch"], SEED + 90)  # [9](c)'s
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    master = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_nccl_rank, args=(r, world, master, batch, results)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got, failed = {}, None
    try:
        for _ in range(world):
            try:
                rank, out = results.get(timeout=600)
            except queue.Empty:
                rank, out = "?", "no answer within 600 s"
            if isinstance(out, str):
                failed = f"rank {rank}: {out}"
                break
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) == world:
        r0 = got[0]
        timed = slice(DP_WARMUP, DP_STEPS)
        step_ms, sync_ms = float(np.median(r0["step_ms"][timed])), float(np.median(r0["sync_ms"][timed]))
        first_rel = abs(r0["losses"][0] / fw["losses"][0] - 1)
        same = all(got[r]["losses"] == r0["losses"] for r in got)
        numbers["nccl"] = {"world": world, "global_batch": fw["batch"], "segment_samples": TRAIN_SEGMENT,
                           "backend": r0["backend"], "step_ms_cuda_events": step_ms, "sync_ms": sync_ms,
                           "phase9_step_ms_cuda_events": fw["step_ms_cuda_events"],
                           "peak_memory_gb": max(got[r]["peak_memory_gb"] for r in got),
                           "losses": r0["losses"], "step1_rel_vs_phase9": first_rel, "ranks": got,
                           "seconds": time.perf_counter() - t0}
        nb = numbers["nccl"]
        check(r0["backend"] == "nccl" and same and all(math.isfinite(v) for v in r0["losses"])
              and (world > 1 or first_rel <= 1e-3),
              f"(b) SPEECH as shipped (bf16), global batch {fw['batch']} x {TRAIN_SEGMENT} samples, {world} rank(s) "
              f"over {r0['backend']}, {DP_STEPS} steps: losses {' '.join(f'{v:.4f}' for v in r0['losses'])}, the "
              f"same on every rank; step 1 {r0['losses'][0]:.6f} vs [9](c)'s one-process step on the same batch "
              f"and draws {fw['losses'][0]:.6f}: rel {first_rel:.2e} (<= 1e-3 at world 1)")
        print(f"  (b) step {step_ms:.2f} ms (CUDA events, median of steps {DP_WARMUP + 1}-{DP_STEPS}) beside [9](c)'s "
              f"{fw['step_ms_cuda_events']:.2f} ms; the gradient sync {sync_ms:.3f} ms a step (one flat bucket, "
              f"{world} rank(s)); peak memory {nb['peak_memory_gb']:.2f} GB; phase (b) {nb['seconds']:.1f} s",
              flush=True)
    else:
        check(False, f"(b) NCCL: {len(got)} of {world} ranks answered; {failed}")

    # (c) the CLI with --n_devices 0: one process per card, through the process group even at one card
    cli_model = CLI_MODEL
    registry_weights = os.path.join(os.path.dirname(get_config_file(cli_model)), "weights.npz")
    tmp = tempfile.mkdtemp(prefix="mbexwn_dp_train_")  # outside the repo
    try:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        make_corpus(data, n_utterances=CLI_UTTERANCES, seed=0, quiet=True)
        t0 = time.perf_counter()
        run = train_cli.main(cli_model, data, out, steps=DP_CLI_STEPS, n_devices=0, save_every=DP_CLI_STEPS,
                             log_every=1, num_workers=2, init_from=registry_weights)
        cli_s = time.perf_counter() - t0
        recs = [json.loads(line) for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
        ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
        check(run["world_size"] == world and run["device"] == "cuda:0" and run["end_step"] == DP_CLI_STEPS
              and [r["step"] for r in recs] == list(range(1, DP_CLI_STEPS + 1))
              and all(math.isfinite(v) for r in recs for v in r.values()) and ckpts == [str(DP_CLI_STEPS)],
              f"(c) cli.train --n_devices 0: {run['world_size']} rank(s) in a process group, rank 0 on "
              f"{run['device']}, steps {[r['step'] for r in recs]} finite, checkpoints {ckpts}, {cli_s:.1f} s")
        counts, k1_err, k2_err = hold_export_kernels(out, check, dev, "(c)")
        for k in launches:
            launches[k] += counts[k]
        steps_ms = [1e3 * run["step_host_s"][k] for k in range(3, DP_CLI_STEPS + 1)]
        numbers["cli"] = {"world": run["world_size"], "steps": DP_CLI_STEPS, "seconds": cli_s,
                          "step_ms_host_median_3_5": float(np.median(steps_ms)), "step_ms_host_3_5": steps_ms,
                          "phase10_step_ms_host_median_3_10": cli_run["cli"]["step_ms_host_median_3_10"],
                          "time_to_first_step_s": run["time_to_first_step_s"], "synthesis_launches": counts,
                          "k1_vs_plain": k1_err, "k2_vs_plain_max_abs": k2_err}
        print(f"  (c) CLI step {numbers['cli']['step_ms_host_median_3_5']:.2f} ms (host clock, median of steps 3-5, "
              f"rank 0) beside [10](a)'s {cli_run['cli']['step_ms_host_median_3_10']:.2f} ms; time to the first "
              f"step {run['time_to_first_step_s']:.2f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) synthesis over a mesh: BatchSynthesizer on [7]'s request set, synth_batched on [8]'s long form
    meshes = {"every card": make_mesh()}
    if world == 1:
        meshes["two replicas on cuda:0"] = make_mesh(devices=["cuda:0", "cuda:0"])
    mels = [m[0] for m in serving_requests(80)]  # BatchSynthesizer takes (T, C) mels
    per_device = {}
    numbers["mesh"] = {}
    for wn_dtype, label, tol in ((None, "bf16", 2e-2), ("", "fp32", 1e-4)):
        model = inverter("SPEECH", wn_dtype).model
        ref = BatchSynthesizer(model, device=dev).synth_batch(mels)
        audio_s = sum(m.shape[0] for m in mels) * model.spect_hop_size / model.sample_rate
        for name, mesh in meshes.items():
            bs = BatchSynthesizer(model, mesh=mesh)
            bs.synth_batch(mels)  # warm-up
            torch.cuda.synchronize()
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            store = {}
            with launches_by_device(per_device), recording_k1(store):
                got = bs.synth_batch(mels)
            counts = dict(kernel_lib.launches)
            err = max(rel_rms(y, r) for y, r in zip(got, ref))
            row = numbers["mesh"].setdefault(name, {"devices": [str(d) for d in mesh.devices]})
            row[f"batch_rel_rms_vs_no_mesh_{label}"] = err
            row[f"batch_launches_{label}"] = counts
            check(err <= tol and all(np.isfinite(y).all() for y in got),
                  f"(d) BatchSynthesizer over a mesh ({name}: {', '.join(row['devices'])}), {label}, {len(mels)} "
                  f"requests: worst rel-RMS against mesh=None {err:.2e} (<= {tol:g}); launches {counts}")
            if label == "bf16":
                for k in launches:
                    launches[k] += counts[k]
                _, k1_max_abs = hold_k1(store, wavenet_stack_plain, check, f"(d) {name} batch")
                numbers["k1_bf16_max_abs"] = max(numbers.get("k1_bf16_max_abs", 0.0), k1_max_abs)
                walls = {"mesh": [], "mesh=None": []}
                plain = BatchSynthesizer(model, device=dev)
                for _ in range(3):
                    for key, synth in (("mesh", bs), ("mesh=None", plain)):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        synth.synth_batch(mels)
                        walls[key].append(1e3 * (time.perf_counter() - t0))
                busy_ms, _, _ = device_activity(lambda: bs.synth_batch(mels))
                wall = float(np.median(walls["mesh"]))
                row.update(audio_s_per_s=audio_s / (wall / 1e3), wall_ms_passes=walls["mesh"],
                           no_mesh_audio_s_per_s=audio_s / (float(np.median(walls["mesh=None"])) / 1e3),
                           idle_share=max(0.0, 1.0 - busy_ms / wall), device_busy_ms=busy_ms)
                print(f"  (d) {name}: {row['audio_s_per_s']:.1f} audio-s/s (mesh=None in the same rounds "
                      f"{row['no_mesh_audio_s_per_s']:.1f}; [7] batch 8 {serving['pipelined batch 8']['audio_s_per_s']:.1f}), "
                      f"idle share {row['idle_share']:.3f}", flush=True)
    # synth_batched over a mesh on [8]'s 60 s long form
    mel_long = make_mel(LONG_FRAMES, 80, SEED + 40)
    for wn_dtype, label, tol in (("", "fp32", 1e-4), (None, "bf16", 2e-2)):
        model = registry_variant("SPEECH", wn_dtype, dev)
        ref = StreamingSynthesizer(model, chunk_frames=LONG_CHUNK, halo_frames=LONG_HALO, device=dev).synth_batched(
            mel_long)
        hop, sr = model.spect_hop_size, model.sample_rate
        for name, mesh in meshes.items():
            ss = StreamingSynthesizer(model, chunk_frames=LONG_CHUNK, halo_frames=LONG_HALO, mesh=mesh)
            ss.synth_batched(mel_long)  # warm-up
            torch.cuda.synchronize()
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            with launches_by_device(per_device):
                y = ss.synth_batched(mel_long)
            counts = dict(kernel_lib.launches)
            err = rel_rms(y, ref)
            row = numbers["mesh"][name]
            row[f"long_form_rel_rms_vs_no_mesh_{label}"] = err
            row[f"long_form_launches_{label}"] = counts
            report = (f"(d) synth_batched over a mesh ({name}), {label}, {LONG_FRAMES} frames (chunk {LONG_CHUNK}, "
                      f"halo {LONG_HALO}): rel-RMS against mesh=None {err:.2e} (<= {tol:g}), launches {counts}")
            if label == "fp32":
                check(err <= tol and np.isfinite(y).all(), report)
                continue
            for k in launches:
                launches[k] += counts[k]
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ss.synth_batched(mel_long)
                walls.append(1e3 * (time.perf_counter() - t0))
            row["long_form_audio_s_per_s"] = LONG_FRAMES * hop / sr / (float(np.median(walls)) / 1e3)
            # reported, not held: a chunk's bf16 audio depends on its batch
            print(f"  report {report}; {row['long_form_audio_s_per_s']:.1f} audio-s/s (median of 3; [8]'s "
                  f"synth_batched {streaming['long_form']['synth_batched']['audio_s_per_s']:.1f})", flush=True)
    numbers["launches_by_device"] = {f"{k} {d}": n for (k, d), n in sorted(per_device.items())}
    print(f"  (d) launches by device over (d)'s counted passes: {numbers['launches_by_device']}", flush=True)
    numbers["launches"] = launches
    return numbers


EXPORT_CASES = (("bf16 batch 1", None, 1), ("bf16 batch 8", None, 8), ("fp32 batch 1", "", 1))
EXPORT_REPS, REMAT_STEPS = 10, 6


def artifact_child(work: str) -> int:
    """Phase [12](a)'s fresh process (`chip_smoke.py --artifact-child DIR`):
    loads each artifact of DIR/cases.json with `compat.export.load_exported`
    alone, asserts that no module of the port's models, nn, config or
    mel_inverter was imported, counts one call's launches, times the call
    (CUDA events on a device mel; host clock with the mel's upload and the
    audio's readback, as `synth_from_mel` does), and writes DIR/child.json
    and DIR/<case>.npy (the audio of the counted call)."""
    import torch
    from mbexwn_vocoder_torch.compat.export import load_exported
    from mbexwn_vocoder_torch.ops import kernel_lib

    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for case in cases:
        t0 = time.perf_counter()
        call, meta = load_exported(os.path.join(work, case["file"]), device="cuda")
        load_s = time.perf_counter() - t0
        mel = np.load(os.path.join(work, case["mel"]))
        mel_dev = torch.from_numpy(mel).cuda()
        for _ in range(3):
            call(mel_dev)
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
        y = call(mel_dev)
        counts = dict(kernel_lib.launches)
        np.save(os.path.join(work, case["name"] + ".npy"), y.cpu().numpy())
        events, host = [], []
        for _ in range(EXPORT_REPS):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            call(mel_dev)
            stop.record()
            torch.cuda.synchronize()
            events.append(start.elapsed_time(stop))
            t0 = time.perf_counter()
            call(mel).cpu().numpy()
            host.append(1e3 * (time.perf_counter() - t0))
        out[case["name"]] = {"load_s": load_s, "launches": counts, "meta": meta,
                             "ms_cuda_events": float(np.median(events)), "ms_host_with_copies": float(np.median(host))}
    forbidden = sorted(k for k in sys.modules if sys.modules[k] is not None and any(
        k == f"mbexwn_vocoder_torch.{m}" or k.startswith(f"mbexwn_vocoder_torch.{m}.")
        for m in ("models", "nn", "config", "mel_inverter")))
    out["imported_model_modules"] = forbidden
    with open(os.path.join(work, "child.json"), "w") as f:
        json.dump(out, f)
    return 0 if not forbidden else 1


def phase_export(inverter, check, dev, synth_ms: float):
    """Phase [12](a): SPEECH exported (bf16 at batch 1 and 8, fp32 at batch
    1; 512 frames; platform cuda), each artifact loaded and run in a fresh
    process that imports no model code, against MELInverter /
    BatchSynthesizer given the same noise rows."""
    import tempfile

    import torch
    from mbexwn_vocoder_torch.compat.export import export_synthesis
    from mbexwn_vocoder_torch.parallel.batch import BatchSynthesizer

    numbers = {}
    with tempfile.TemporaryDirectory() as work:
        cases, refs = [], {}
        for name, wn_dtype, B in EXPORT_CASES:
            inv = inverter("SPEECH", wn_dtype)
            mels = [make_mel(N_FRAMES, 80, SEED + 100 + i) for i in range(B)]
            t0 = time.perf_counter()
            blob = export_synthesis(inv.model, T_mel=N_FRAMES, batch_size=B, platforms=("cuda",))
            export_s = time.perf_counter() - t0
            fname = name.replace(" ", "_")
            with open(os.path.join(work, fname + ".pt2aot"), "wb") as f:
                f.write(blob)
            np.save(os.path.join(work, fname + "_mel.npy"), np.concatenate(mels))
            cases.append({"name": name, "file": fname + ".pt2aot", "mel": fname + "_mel.npy"})
            if B == 1:  # synth_from_mel draws the noise a group of one draws
                refs[name] = inv.synth_from_mel(mels[0])[None]
            else:  # one group of B in the 512 bucket: row i of one (B, L, 1) draw
                refs[name] = np.stack(BatchSynthesizer(inv.model, device=dev).synth_batch([m[0] for m in mels]))
            numbers[name] = {"export_s": export_s, "bytes": len(blob)}
            print(f"  (a) exported {name}: {export_s:.1f} s, {len(blob)} bytes", flush=True)
        with open(os.path.join(work, "cases.json"), "w") as f:
            json.dump(cases, f)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--artifact-child", work],
                               capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != 0 or not os.path.exists(os.path.join(work, "child.json")):
            check(False, f"(a) the artifact process failed (exit {child.returncode}):\n{child.stderr[-4000:]}")
            return numbers
        with open(os.path.join(work, "child.json")) as f:
            got = json.load(f)
        outs = {name: np.load(os.path.join(work, name + ".npy")) for name, _, _ in EXPORT_CASES}
    check(not got["imported_model_modules"],
          f"(a) the loading process ({child_s:.1f} s) imported none of the port's models, nn, config, mel_inverter "
          f"({got['imported_model_modules']})")
    launches = {"wavenet_layer": 0, "oscillator": 0}
    for name, wn_dtype, B in EXPORT_CASES:
        g, tol = got[name], (2e-2 if wn_dtype is None else 1e-5)
        err = rel_rms(outs[name], refs[name])
        numbers[name].update(load_s=g["load_s"], launches=g["launches"], rel_rms=err,
                             bit_equal=bool(np.array_equal(outs[name], refs[name])),
                             ms_cuda_events=g["ms_cuda_events"], ms_host_with_copies=g["ms_host_with_copies"],
                             meta=g["meta"])
        for k in launches:
            launches[k] += g["launches"][k]
        check(g["launches"] == {"wavenet_layer": 24, "oscillator": 1},
              f"(a) {name}: one call of the loaded artifact launches {g['launches']} (24 K1 + 1 K2)")
        check(outs[name].shape == refs[name].shape and np.isfinite(outs[name]).all() and err <= tol,
              f"(a) {name}: the artifact against {'MELInverter.synth_from_mel' if B == 1 else 'BatchSynthesizer'} "
              f"with the same noise rows: rel-RMS {err:.3e} (<= {tol:g}), bit-equal "
              f"{numbers[name]['bit_equal']}; load {g['load_s']:.2f} s; call {g['ms_cuda_events']:.2f} ms "
              f"(CUDA events) / {g['ms_host_with_copies']:.2f} ms (host clock with the copies; [5]'s synth_from_mel "
              f"{synth_ms:.2f} ms)")
    numbers["launches"] = launches
    numbers["child_s"] = child_s
    return numbers


def phase_remat(check, dev, training):
    """Phase [12](b): [9](c)'s configuration with remat_wavenet_blocks:
    step ms, peak memory and step 1's loss beside [9](c)'s; the fp32
    gradient against the non-remat step on the same draws; the tiny fp64
    case, card remat against card non-remat."""
    import torch
    from mbexwn_vocoder_torch import get_config_file
    from mbexwn_vocoder_torch.config import read_config
    from mbexwn_vocoder_torch.models import create_model, create_registry_model
    from mbexwn_vocoder_torch.training.parity import hold_leaves, tiny_batch, tiny_hparams
    from mbexwn_vocoder_torch.training.trainer import Trainer

    full = training["full_width"]
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):  # as shipped: bf16, as [9](c)
        os.environ.pop(var, None)
    hp = read_config(get_config_file("SPEECH"))
    hp_remat = read_config(get_config_file("SPEECH"))
    hp_remat["mbexwn_config"]["remat_wavenet_blocks"] = True
    batch = training_batch(hp["preprocess_config"], hp["training_config"]["train_batch_size"], SEED + 90)
    batch = {k: v[:full["batch"]] for k, v in batch.items()}
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    tr = Trainer(create_registry_model("SPEECH", trainable=True, remat_wavenet_blocks=True), hp_remat, device=dev)
    check(tr.model.block.remat_wavenet_blocks, "(b) the trainer takes remat_wavenet_blocks")
    torch.cuda.reset_peak_memory_stats()
    losses, event_ms = [float(tr.train_step(batch)["total_loss"])], []
    for _ in range(1, REMAT_STEPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        metrics = tr.train_step(batch)
        stop.record()
        torch.cuda.synchronize()
        event_ms.append(start.elapsed_time(stop))
        losses.append(float(metrics["total_loss"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median(event_ms[1:]))
    del tr
    numbers = {"batch": full["batch"], "losses": losses, "step_ms_cuda_events": step_ms, "step_ms_all": event_ms,
               "peak_memory_gb": peak_gb, "allocated_before_gb": base_gb,
               "no_remat_step_ms": full["step_ms_cuda_events"], "no_remat_peak_gb": full["peak_memory_gb"],
               "no_remat_first_loss": full["losses"][0]}
    check(losses[0] == full["losses"][0] and all(math.isfinite(v) for v in losses),
          f"(b) SPEECH bf16 batch {full['batch']} with remat: step 1's loss {losses[0]:.7g} equals [9](c)'s "
          f"{full['losses'][0]:.7g} (same weights and draws); {REMAT_STEPS} losses finite")
    check(peak_gb < full["peak_memory_gb"],
          f"(b) remat step {step_ms:.2f} ms (CUDA events, median of steps 3-{REMAT_STEPS}) against [9](c)'s "
          f"{full['step_ms_cuda_events']:.2f} ms; peak memory {peak_gb:.2f} GB (of which {base_gb:.2f} GB held "
          f"before) below [9](c)'s {full['peak_memory_gb']:.2f} GB")

    # the fp32 gradient of one step with and without remat, on the same weights and draws
    grads = {}
    g = torch.Generator().manual_seed(SEED + 12)
    draws = None
    for name, hparams, remat in (("no remat", hp, False), ("remat", hp_remat, True)):
        t = Trainer(create_registry_model("SPEECH", trainable=True, remat_wavenet_blocks=remat), hparams,
                    device=dev)
        if draws is None:
            draws = {k: (torch.rand(s, generator=g) * 2 - 1 if k == "floor" else torch.randn(s, generator=g))
                     for k, s in t.draw_shapes(batch).items()}
        _, _, gr = t.value_and_grad(batch, 0, draws)
        grads[name] = {k: v.detach().double().cpu().numpy() for k, v in gr.items()}
        del t, gr
        torch.cuda.empty_cache()
    worst = max((rel_rms(grads["remat"][k], grads["no remat"][k]), k) for k in grads["remat"])
    numbers["fp32_gradient_worst_rel_rms"] = {"leaf": worst[1], "rel_rms": worst[0]}
    print(f"  (b) fp32 gradient, remat against no remat (same weights, batch, draws; bf16 compute): worst leaf "
          f"{worst[1]} rel-RMS {worst[0]:.3e} (reported: cuDNN's bf16 backward is not deterministic)", flush=True)

    # the tiny case in fp64: card remat against card non-remat
    saved = {v: os.environ.get(v) for v in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE")}
    try:
        for v in saved:
            os.environ[v] = ""
        tiny = {}
        for remat in (False, True):
            thp = tiny_hparams(**{"mbexwn_config.remat_wavenet_blocks": remat})
            m, _ = create_model(thp, thp["training_config"], thp["preprocess_config"], trainable=True)
            m.init(torch.Generator().manual_seed(SEED))
            t = Trainer(m.double(), thp, device=dev)
            tb = tiny_batch()
            tdraws = {k: torch.randn(s, generator=torch.Generator().manual_seed(SEED + 1), dtype=torch.float64)
                      for k, s in t.draw_shapes(tb).items()}
            loss, _, gr = t.value_and_grad(tb, 0, tdraws)
            tiny[remat] = (float(loss), {k: v.detach().cpu().numpy() for k, v in gr.items()})
    finally:
        for v, val in saved.items():
            if val is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = val
    bad, rows = hold_leaves(tiny[True][1], tiny[False][1], 1e-12)
    loss_rel = abs(tiny[True][0] / tiny[False][0] - 1)
    numbers["tiny_fp64"] = {"loss_rel": loss_rel, "worst_leaf": rows[0][1], "worst_rel_rms": rows[0][0]}
    check(not bad and loss_rel <= 1e-12,
          f"(b) tiny case in fp64 on the card, remat against no remat: loss rel {loss_rel:.1e} (<= 1e-12), worst "
          f"leaf {rows[0][1]} {rows[0][0]:.1e} (<= 1e-12); failing {bad}")
    return numbers


def phase_observability(inverter, check, dev, synth_ms: float):
    """Phase [12](c): profile_trace, debug_nans, dump_controls and
    synthesis_flops on SPEECH as shipped (bf16), 512 frames."""
    import glob
    import tempfile

    import torch
    from mbexwn_vocoder_torch.compat.iovar import load_var
    from mbexwn_vocoder_torch.observability import debug_nans, dump_controls, profile_trace, synthesis_flops
    from mbexwn_vocoder_torch.ops import kernel_lib

    inv = inverter("SPEECH", None)
    mel = make_mel(N_FRAMES, 80, SEED)
    numbers, launches = {}, {"wavenet_layer": 0, "oscillator": 0}

    def counted(what, fn):
        torch.cuda.synchronize()
        kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
        out = fn()
        torch.cuda.synchronize()
        counts = dict(kernel_lib.launches)
        for k in launches:
            launches[k] += counts[k]
        check(counts == {"wavenet_layer": 24, "oscillator": 1}, f"(c) {what}: launches {counts} (24 K1 + 1 K2)")
        return out

    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "trace")
        with profile_trace(log_dir) as prof:
            counted("one synthesis under profile_trace", lambda: inv.synth_from_mel(mel))
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        k1_ms = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                    for e in prof.key_averages() if "wavenet_layer_bf16" in e.key) / 1e3
        numbers["trace_bytes"] = len(text)
        numbers["trace_k1_device_ms"] = k1_ms
        check(len(files) == 1 and "wavenet_layer_bf16" in text and "mbexwn::wavenet_stack" in text,
              f"(c) profile_trace wrote {len(files)} trace file(s) ({len(text)} bytes) naming K1's kernel "
              f"wavenet_layer_bf16 ({k1_ms:.3f} ms of device time there) and the op mbexwn::wavenet_stack")

        t0 = time.perf_counter()
        for _ in range(3):
            inv.synth_from_mel(mel)
        plain_ms = 1e3 * (time.perf_counter() - t0) / 3
        with debug_nans():
            counted("one synthesis under debug_nans", lambda: inv.synth_from_mel(mel))
            t0 = time.perf_counter()
            for _ in range(3):
                inv.synth_from_mel(mel)
            nan_ms = 1e3 * (time.perf_counter() - t0) / 3
        bad = mel.copy()
        bad[0, 100, 10] = np.nan
        raised = None
        try:
            with debug_nans():
                inv.synth_from_mel(bad)
        except FloatingPointError as e:
            raised = str(e)
        numbers.update(debug_nans_ms=nan_ms, plain_ms=plain_ms, debug_nans_raised=raised)
        check(raised is not None and "produced a NaN" in raised,
              f"(c) debug_nans: silent over one bf16 synthesis ({nan_ms:.2f} ms against {plain_ms:.2f} ms without, "
              f"host clock, mean of 3); a NaN planted in the mel raises: {raised}")

        path = os.path.join(tmp, "controls.pkl")
        data = counted("dump_controls", lambda: dump_controls(path, inv.model, mel))
        saved = load_var(path)
        shapes = {k: tuple(v.shape) for k, v in saved.items()}
        numbers["dump_controls_shapes"] = shapes
        check(sorted(saved) == sorted(data) == ["PulseFilterSpectrum", "pulse_frequency", "pulse_signal",
                                                "upsampled_rms"] and all(np.isfinite(v).all() for v in saved.values()),
              f"(c) dump_controls at {N_FRAMES} frames: {shapes}, finite")
    flops = synthesis_flops(inv.model, N_FRAMES, 1)
    numbers["synthesis_flops"] = flops
    numbers["tflops_per_s_at_synthesis_ms"] = flops["flops_per_call"] / (synth_ms / 1e3) / 1e12
    print(f"  (c) synthesis_flops(SPEECH, {N_FRAMES}, 1): {flops['flops_per_call'] / 1e9:.2f} GFLOP a call "
          f"({', '.join(f'{k} {v / 1e9:.2f}' for k, v in flops['breakdown'].items())} GFLOP), "
          f"{numbers['tflops_per_s_at_synthesis_ms']:.2f} TFLOP/s at [5]'s {synth_ms:.2f} ms "
          f"({100 * numbers['tflops_per_s_at_synthesis_ms'] * 1e12 / H100_BF16_FLOPS:.2f} % of 989 TFLOP/s)",
          flush=True)
    numbers["launches"] = launches
    return numbers


ROUTE_CPU_FRAMES = 128  # [13](a): the card-vs-CPU checks' mel (the timing runs at N_FRAMES)
BRANCH_CASES = (("glu", dict(activation="glu")), ("gsu", dict(activation="gsu")),
                ("n_ch_groups 2", dict(n_ch_groups=2)), ("kernel_size 5", dict(kernel_size=5)))
TP_BATCH = 2  # [13](b)
INT8_BATCHES = (1, 8)  # [13](c)


@contextlib.contextmanager
def recording_int8_layers(store: list):
    """A context in which the int8 mode's layers (nn/wavenet.py's
    `int8_layer`) run as before and each call appends (x, cond, weights,
    dilation, activation, its output) to `store`."""
    import mbexwn_vocoder_torch.nn.wavenet as wn_module

    real = wn_module.int8_layer

    def recording(x, cond, weights, dilation, activation):
        out = real(x, cond, weights, dilation, activation)
        store.append((x.clone(), None if cond is None else cond.clone(), weights, dilation, activation, out.clone()))
        return out

    wn_module.int8_layer = recording
    try:
        yield store
    finally:
        wn_module.int8_layer = real


def card_f0(model, mel, synth_length: int):
    """The F0 contour (B, T_mel * spect_to_pulse) `model.infer` computes for
    `mel` (RMS-normalised where the model normalises)."""
    import torch
    from mbexwn_vocoder_torch.ops.precision import exact_fp32

    with torch.inference_mode(), exact_fp32():
        if model.norm_mel_components is not None:
            _, mel, _ = model.norm_mel_components.normalize_inputs_by_rms(None, mel, synth_length)
        return model.block.generate_f0(mel)


def branch_model(edit: dict, wn_dtype, dev, config_edit=None):
    """SPEECH with `pp_mod_subnet` edited (and `config_edit` applied to its
    whole mbexwn_config, the NormMel keys included), randomly initialised
    (seeded), with the compute dtype forced as `registry_variant` forces it."""
    import torch
    from mbexwn_vocoder_torch import get_config_file
    from mbexwn_vocoder_torch.config import read_config
    from mbexwn_vocoder_torch.models import create_model

    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        if wn_dtype is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = wn_dtype
    hp = read_config(get_config_file("SPEECH"))
    hp["mbexwn_config"]["pp_mod_subnet"].update(edit)
    if config_edit is not None:
        config_edit(hp["mbexwn_config"])
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.init(torch.Generator().manual_seed(SEED + 130))
    return model.eval().to(dev)


def per_layer_stack(dtype, dev):
    """A standalone WaveNetAE at SPEECH's width (C=320, 12 layers, k=3, gtu)
    with per-layer conditioning (`cond_conv_upsampling=None`: one cond conv of
    2*320*12 channels on a mel at the stack's rate), randomly initialised."""
    import torch
    from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm
    from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE

    net = WaveNetAE(7, 80, n_channels=320, n_layers=12, kernel_size=3, n_out_channels=64, max_log2_dilation_rate=7,
                    cond_kernel_size=3, cond_conv_upsampling=None, compute_dtype=dtype, name="per_layer")
    gen = torch.Generator().manual_seed(SEED + 131)
    for m in net.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.init(gen)
    return net.eval().requires_grad_(False).to(dev)


@contextlib.contextmanager
def counting_reduces(store: list, label: str = "tp.reduce_add"):
    """A context in which tensor parallelism's per-layer reduce runs as
    before, inside a profiler range named `label`, and each call appends its
    count of partials to `store`."""
    import torch
    from mbexwn_vocoder_torch.parallel import tensor

    real = tensor.reduce_add

    def counted(partials, home):
        store.append(len(partials))
        with torch.profiler.record_function(label):
            return real(partials, home)

    tensor.reduce_add = counted
    try:
        yield store
    finally:
        tensor.reduce_add = real


def phase_routes(inverter, check, dev, synth_ms: float, serving):
    """Phase [13]: every route of the WaveNet stack on the card, SPEECH full
    width.  (a) the branches the kernel does not take: SPEECH with
    pp_mod_subnet's gate glu / gsu, n_ch_groups 2, kernel_size 5, and a
    standalone 320-channel stack with per-layer conditioning; random init;
    fp32 card against the port's CPU (<= 1e-3 rel-RMS), K1 launches 0 (24
    for the unedited gtu model, the reference run), bf16 synthesis ms by
    CUDA events beside the reference's and [5]'s.  (b) tensor parallelism:
    SPEECH's shipped weights built with MBEXWN_TP_AXIS=model, a 1 x 2 mesh
    of cuda:0 twice, BatchSynthesizer at batch 2, 512 frames, against the
    same model unsharded (fp32 <= 1e-5, bf16 <= 2e-2), K1 launches 0, ms a
    synthesis and the reduce's share of its device time.  (c) the int8 mode
    (MBEXWN_WN_QUANT=int8), SPEECH shipped bf16, batch 1 and 8, 512 frames:
    each int8 layer of the card's synthesis against the CPU's on the same
    inputs (<= 2e-2; the whole synthesis card against CPU is read, not
    held), the synthesis against card bf16 (> 1e-3),
    2 x 12 x 2 torch._int_mm calls a synthesis, ms beside bf16 in the same
    rounds, and the quality round trip's mean mel-L1 beside [7]'s bf16
    figure (recorded, not gated).  (d) the int8 artifact at batch 1, loaded
    in a fresh process (`--artifact-child`), against the direct int8
    synthesis: bit-equal, or < 1e-2 and < 0.1 x its distance to bf16."""
    import copy
    import tempfile

    import torch
    from mbexwn_vocoder_torch.compat.export import export_synthesis
    from mbexwn_vocoder_torch.mel_inverter import edge_pad
    from mbexwn_vocoder_torch.ops import kernel_lib, quant
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.parallel.batch import BatchSynthesizer
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh

    numbers = {"branches": {}, "launches": {"wavenet_layer": 0, "oscillator": 0}}

    def add_launches(counts):
        for k in numbers["launches"]:
            numbers["launches"][k] += counts[k]

    # (a) the branches
    mel_cpu = make_mel(ROUTE_CPU_FRAMES, 80, SEED + 132)
    mel_full = make_mel(N_FRAMES, 80, SEED)
    for name, edit in (("gtu (reference)", {}),) + BRANCH_CASES:
        row = numbers["branches"][name] = {}
        model_cpu = branch_model(edit, "", "cpu")
        model = copy.deepcopy(model_cpu).to(dev)
        blk = model.block
        noise = torch.from_numpy(np.random.RandomState(SEED + 133).randn(
            1, blk.wn_input_length(ROUTE_CPU_FRAMES), 1).astype(np.float32))
        length = ROUTE_CPU_FRAMES * model.spect_hop_size
        with torch.inference_mode():
            y_cpu = model_cpu.infer(torch.from_numpy(mel_cpu), synth_length=length, noise=noise).numpy()
            model.infer(torch.from_numpy(mel_cpu).to(dev), synth_length=length, noise=noise.to(dev))
            torch.cuda.synchronize()
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            y = model.infer(torch.from_numpy(mel_cpu).to(dev), synth_length=length, noise=noise.to(dev))
            torch.cuda.synchronize()
            counts = dict(kernel_lib.launches)
        add_launches(counts)
        y = y.cpu().numpy()
        err = rel_rms(y, y_cpu)
        k1_expected = 24 if not edit else 0
        routes = sorted({getattr(blk, n).wavenet.route() for n in blk.block_names})
        row.update(fp32_card_vs_cpu_rel_rms=err, launches_fp32=counts, routes=routes)
        check(np.isfinite(y).all() and err <= 1e-3 and counts == {"wavenet_layer": k1_expected, "oscillator": 1},
              f"(a) SPEECH {name}, random init, fp32 {ROUTE_CPU_FRAMES} frames: card vs CPU rel-RMS {err:.3e} "
              f"(<= 1e-3); route {routes}; launches {counts} (K1 {k1_expected})")
        model16 = branch_model(edit, None, dev)
        mel_dev = torch.from_numpy(mel_full).to(dev)
        noise16 = torch.randn((1, blk.wn_input_length(N_FRAMES), 1), generator=torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        full = N_FRAMES * model16.spect_hop_size
        with torch.inference_mode():
            y16 = model16.infer(mel_dev, synth_length=full, noise=noise16)
            ms = cuda_time_ms(lambda: model16.infer(mel_dev, synth_length=full, noise=noise16), iters=5)
        row.update(bf16_ms_cuda_events=ms, bf16_finite=bool(torch.isfinite(y16).all()))
        check(row["bf16_finite"], f"(a) SPEECH {name}, bf16 {N_FRAMES} frames: {y16.shape[1]} finite samples, "
                                  f"synthesis {ms:.2f} ms (CUDA events; [5]'s synth_from_mel {synth_ms:.2f} ms)")
        del model, model_cpu, model16
    ref_ms = numbers["branches"]["gtu (reference)"]["bf16_ms_cuda_events"]
    row = numbers["branches"]["per-layer conditioning (standalone WaveNetAE)"] = {}
    net_cpu = per_layer_stack(None, "cpu")
    net = copy.deepcopy(net_cpu).to(dev)
    rng = np.random.RandomState(SEED + 134)
    rows_cpu, rows_full = ROUTE_CPU_FRAMES * 25, N_FRAMES * 25  # block 0's rate
    audio = torch.from_numpy(rng.randn(1, rows_cpu, 7).astype(np.float32) * 0.5)
    cmel = torch.from_numpy(rng.randn(1, rows_cpu, 80).astype(np.float32) * 0.5)
    with torch.inference_mode(), exact_fp32():
        ref = net_cpu(audio, cmel).numpy()
        kernel_lib.reset_launch_counts()
        got = net(audio.to(dev), cmel.to(dev))
        torch.cuda.synchronize()
        counts = dict(kernel_lib.launches)
    add_launches(counts)
    err = rel_rms(got.cpu().numpy(), ref)
    net16 = per_layer_stack(torch.bfloat16, dev)
    a_full = torch.randn((1, rows_full, 7), device=dev) * 0.5
    m_full = torch.randn((1, rows_full, 80), device=dev) * 0.5
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: net16(a_full, m_full), iters=5)
        finite = bool(torch.isfinite(net16(a_full, m_full)).all())
    row.update(fp32_card_vs_cpu_rel_rms=err, launches_fp32=counts, route=net.route(), bf16_ms_cuda_events=ms,
               rows=rows_full)
    check(err <= 1e-3 and finite and counts == {"wavenet_layer": net.n_layers, "oscillator": 0},
          f"(a) standalone WaveNetAE C=320 with per-layer conditioning ({net.cond.filters} cond channels), fp32 "
          f"{rows_cpu} rows: card vs CPU rel-RMS {err:.3e} (<= 1e-3); route {net.route()}; launches {counts}; "
          f"bf16 {rows_full} rows (block 0 of a {N_FRAMES}-frame synthesis): {ms:.2f} ms (CUDA events)")
    print(f"  (a) bf16 synthesis ms (CUDA events, {N_FRAMES} frames): " + ", ".join(
        f"{k} {v['bf16_ms_cuda_events']:.2f}" for k, v in numbers["branches"].items() if "standalone" not in k)
        + f"; the gtu reference through K1 {ref_ms:.2f}; [5]'s synth_from_mel {synth_ms:.2f} (host clock)",
        flush=True)

    # (b) tensor parallelism over a model axis of cuda:0 twice
    numbers["tp"] = {"mesh": "make_mesh(n_data=1, n_model=2, devices=['cuda:0', 'cuda:0'])",
                     "cross_card": "not measured: the host has one card"}
    mels = [make_mel(N_FRAMES, 80, SEED + 140 + i)[0] for i in range(TP_BATCH)]
    os.environ["MBEXWN_TP_AXIS"] = "model"
    try:
        for wn_dtype, label, tol in (("", "fp32", 1e-5), (None, "bf16", 2e-2)):
            model = registry_variant("SPEECH", wn_dtype, dev)
            ref = BatchSynthesizer(model, device=dev).synth_batch(mels)  # built with the axis, unsharded
            bs = BatchSynthesizer(model, mesh=make_mesh(n_data=1, n_model=2, devices=["cuda:0", "cuda:0"]))
            stacks = [getattr(bs.model.block, n).wavenet for n in bs.model.block.block_names]
            bs.synth_batch(mels)  # warm-up
            torch.cuda.synchronize()
            reduces = []
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            with counting_reduces(reduces):
                got = bs.synth_batch(mels)
            counts = dict(kernel_lib.launches)
            add_launches(counts)
            err = max(rel_rms(y, r) for y, r in zip(got, ref))
            n_layers = sum(wn.n_layers for wn in stacks)
            check(all(np.isfinite(y).all() for y in got) and err <= tol
                  and counts == {"wavenet_layer": 0, "oscillator": 1} and reduces == [2] * n_layers
                  and all(wn.tp_devices == (dev, dev) for wn in stacks),
                  f"(b) tensor parallel {label}, BatchSynthesizer batch {TP_BATCH}, {N_FRAMES} frames, channels "
                  f"split over cuda:0 twice: rel-RMS against the same model unsharded {err:.3e} (<= {tol:g}); "
                  f"launches {counts} (K1 0); {len(reduces)} reduces of {sorted(set(reduces))} partials "
                  f"({n_layers} layers)")
            replica = bs.model
            mel_dev = torch.from_numpy(np.stack(mels)).to(dev)
            noise = torch.randn((TP_BATCH, replica.block.wn_input_length(N_FRAMES), 1), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(0))
            full = N_FRAMES * replica.spect_hop_size
            with torch.inference_mode():
                ms = cuda_time_ms(lambda: replica.infer(mel_dev, synth_length=full, noise=noise), iters=5)
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                        counting_reduces([]):
                    replica.infer(mel_dev, synth_length=full, noise=noise)
                    torch.cuda.synchronize()
            busy_ms, n_spans, _ = device_busy(prof)
            reduce_ms = sum(getattr(ev, "device_time_total", 0.0) for ev in prof.events()
                            if ev.name == "tp.reduce_add") / 1e3
            numbers["tp"][label] = {"rel_rms_vs_unsharded": err, "launches": counts, "reduces": len(reduces),
                                    "ms_cuda_events": ms, "device_busy_ms": busy_ms, "reduce_device_ms": reduce_ms,
                                    "reduce_share_of_busy": reduce_ms / busy_ms if busy_ms else None}
            print(f"  (b) {label}: synthesis batch {TP_BATCH} {ms:.2f} ms (CUDA events); device busy {busy_ms:.2f} ms "
                  f"in {n_spans} activities, the reduces' kernels {reduce_ms:.3f} ms "
                  f"({100 * reduce_ms / max(busy_ms, 1e-9):.2f} %); no cross-card number: the host has one card",
                  flush=True)
            del model, bs, replica
    finally:
        os.environ.pop("MBEXWN_TP_AXIS", None)

    # (c) the int8 mode, SPEECH shipped bf16
    import mbexwn_vocoder_torch.nn.wavenet as wn_module

    inv = inverter("SPEECH", None)
    cpu_inv = inverter("SPEECH", None, device="cpu")
    numbers["int8"] = {}
    records = []
    try:
        for B in INT8_BATCHES:
            mels = [make_mel(N_FRAMES, 80, SEED + 150 + i) for i in range(B)]
            mel_b = np.concatenate(mels)
            noise = np.random.RandomState(SEED + 151).randn(*inv.noise_shape(mel_b)).astype(np.float32)
            os.environ.pop(quant.QUANT_ENV, None)
            y16 = inv.synth_from_mel(mel_b, noise=noise)
            os.environ[quant.QUANT_ENV] = "int8"
            inv.synth_from_mel(mel_b, noise=noise)  # warm-up: quantizes the weights once
            torch.cuda.synchronize()
            n_mm = quant.int_mm_calls
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            with recording_int8_layers(records):
                y8 = inv.synth_from_mel(mel_b, noise=noise)
            counts = dict(kernel_lib.launches)
            n_mm = quant.int_mm_calls - n_mm
            add_launches(counts)
            # the held check: every int8 layer of that synthesis against the CPU's on the very inputs and
            # quantized weights the card's layer had (the products are exact on both; a value within rounding
            # of a round-half tie, or of a tanh/sigmoid ulp, may land in the next bin)
            layer_errs = []
            for x, cond, weights, dil, act, out in records:
                cpu_w = tuple(quant.Int8Weight(w.q.cpu(), w.scale.cpu(), None if w.bias is None else w.bias.cpu())
                              for w in weights)
                with torch.inference_mode():
                    ref = wn_module.int8_layer(x.cpu(), None if cond is None else cond.cpu(), cpu_w, dil, act)
                layer_errs.append(rel_rms(out.float().cpu().numpy(), ref.float().numpy()))
            records.clear()
            err_cpu, err_bf16 = max(layer_errs), rel_rms(y8, y16)
            if B == 1:
                # readings of the whole synthesis, card against CPU (not held: each bin flip perturbs one value by
                # a quantization step, the next layers quantize what they are given, and so a rounding
                # difference anywhere spreads into a different set of bins downstream): the card's F0 handed
                # to both, bf16; each device's own F0 net, fp32; and the control, bf16 without the int8 mode,
                # where the two bf16 F0 nets' contours drift the phase of 76,800 oscillator samples apart
                mel_pad = torch.from_numpy(edge_pad(mel_b, inv._bucket_len(N_FRAMES)))  # as synth_from_mel pads
                full = mel_pad.shape[1] * inv.hop_size
                f0 = card_f0(inv.model, mel_pad.to(dev), full)
                with torch.inference_mode():
                    y8_f0 = inv.model.infer(mel_pad.to(dev), synth_length=full, F0=f0,
                                            noise=torch.from_numpy(noise).to(dev)).cpu().numpy()
                    y8_cpu = cpu_inv.model.infer(mel_pad, synth_length=full, F0=f0.cpu(),
                                                 noise=torch.from_numpy(noise)).numpy()
                fp32 = {d: inverter("SPEECH", "", device=d) for d in ("cuda", "cpu")}
                err_fp32 = rel_rms(fp32["cuda"].synth_from_mel(mel_b, noise=noise),
                                   fp32["cpu"].synth_from_mel(mel_b, noise=noise))
                os.environ.pop(quant.QUANT_ENV, None)
                control = rel_rms(y16, cpu_inv.synth_from_mel(mel_b, noise=noise))
                os.environ[quant.QUANT_ENV] = "int8"
                numbers["int8"]["whole_synthesis_card_vs_cpu"] = {
                    "int8_bf16_card_f0": rel_rms(y8_f0, y8_cpu), "int8_fp32_own_f0": err_fp32,
                    "bf16_no_int8_own_f0": control}
                print(f"  (c) whole synthesis, card against CPU (read, not held): int8 bf16 with the card's F0 "
                      f"{rel_rms(y8_f0, y8_cpu):.3e}; int8 fp32, each device's own F0 net {err_fp32:.3e}; bf16 "
                      f"without int8, each device's own F0 net {control:.3e}", flush=True)
            walls = {"int8": [], "bf16": []}
            for _ in range(10):
                for mode in ("int8", "bf16"):
                    if mode == "int8":
                        os.environ[quant.QUANT_ENV] = "int8"
                    else:
                        os.environ.pop(quant.QUANT_ENV, None)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    inv.synth_from_mel(mel_b, noise=noise)
                    walls[mode].append(1e3 * (time.perf_counter() - t0))
            os.environ[quant.QUANT_ENV] = "int8"
            busy = {}
            for mode in ("bf16", "int8"):  # where the device time goes, one synthesis each under the profiler
                os.environ[quant.QUANT_ENV] = "int8" if mode == "int8" else ""
                busy[mode] = device_activity(lambda: inv.synth_from_mel(mel_b, noise=noise))
            os.environ[quant.QUANT_ENV] = "int8"
            top = sorted(busy["int8"][2].items(), key=lambda kv: -kv[1][0])[:6]
            print(f"  (c) batch {B}: device busy int8 {busy['int8'][0]:.2f} ms in {busy['int8'][1]} activities, bf16 "
                  f"{busy['bf16'][0]:.2f} ms in {busy['bf16'][1]}; int8's top kernels: "
                  + "; ".join(f"{ms:.2f} ms {n}x {name[:60]}" for name, (ms, n) in top), flush=True)
            row = numbers["int8"][f"batch {B}"] = {
                "device_busy_ms": {m: v[0] for m, v in busy.items()},
                "device_activities": {m: v[1] for m, v in busy.items()},
                "int8_top_kernels": [[name, ms, n] for name, (ms, n) in top],
                "worst_layer_rel_rms_vs_cpu_int8": err_cpu, "layer_rel_rms_vs_cpu_int8": layer_errs,
                "rel_rms_vs_card_bf16": err_bf16, "int_mm_calls": n_mm,
                "launches": counts, "ms_host_int8": float(np.median(walls["int8"])),
                "ms_host_bf16": float(np.median(walls["bf16"])), "ms_host_int8_passes": walls["int8"],
                "ms_host_bf16_passes": walls["bf16"]}
            check(y8.shape == y16.shape and np.isfinite(y8).all() and err_cpu <= 2e-2 and err_bf16 > 1e-3
                  and n_mm == 2 * 12 * 2 and counts == {"wavenet_layer": 0, "oscillator": 1},
                  f"(c) int8 SPEECH batch {B}, {N_FRAMES} frames: each of its {len(layer_errs)} int8 layers against "
                  f"the CPU's on the same inputs, worst rel-RMS {err_cpu:.3e} (<= 2e-2); the synthesis vs card bf16 "
                  f"{err_bf16:.3e} (> 1e-3); torch._int_mm calls {n_mm} "
                  f"(2 x 12 x 2); launches {counts}; synthesis {row['ms_host_int8']:.2f} ms int8 against "
                  f"{row['ms_host_bf16']:.2f} ms bf16 (host clock, median of 10 alternating rounds; [5]'s bf16 "
                  f"{synth_ms:.2f} ms)")
        from mbexwn_vocoder_torch.compat.audio_io import read_wav
        from mbexwn_vocoder_torch.quality import V2_EVAL_SETS, round_trip, summarize
        from mbexwn_vocoder_torch.training.synthetic import make_corpus

        corpus, seed, style = V2_EVAL_SETS["SPEECH"]
        with tempfile.TemporaryDirectory() as tmp:
            paths = make_corpus(os.path.join(tmp, corpus), n_utterances=8, seed=seed, style=style, quiet=True)
            sounds = [(os.path.basename(p), *read_wav(p)) for p in paths]
        means = summarize(round_trip(inv, sounds, depth=3, batch=8))
        bf16_l1 = serving["quality"]["mean_mel_L1_dB"]
        numbers["int8"]["quality"] = {**means, "bf16_mean_mel_L1_dB": bf16_l1}
        print(f"  (c) quality round trip, SPEECH int8, {corpus} (8 files, batch 8): mean mel-L1 "
              f"{means['mean_mel_L1_dB']:.3f} dB against bf16 {bf16_l1:.3f} ([7]; "
              f"{means['mean_mel_L1_dB'] - bf16_l1:+.3f} dB; recorded, not gated)", flush=True)

        # (d) the int8 artifact, batch 1, loaded in a fresh process
        mel1 = make_mel(N_FRAMES, 80, SEED + 160)
        direct = inv.synth_from_mel(mel1)[None]  # the serving noise: a generator seeded 0, as the program holds
        t0 = time.perf_counter()
        blob = export_synthesis(inv.model, T_mel=N_FRAMES, batch_size=1, platforms=("cuda",))
        export_s = time.perf_counter() - t0
    finally:
        os.environ.pop(quant.QUANT_ENV, None)
    bf16_direct = inv.synth_from_mel(mel1)[None]
    import io

    meta_len = int.from_bytes(blob[len(b"MBEXWN_TORCH_AOT1\n"):len(b"MBEXWN_TORCH_AOT1\n") + 8], "little")
    meta = json.loads(blob[len(b"MBEXWN_TORCH_AOT1\n") + 8:len(b"MBEXWN_TORCH_AOT1\n") + 8 + meta_len])
    graph = torch.export.load(io.BytesIO(blob[-meta["program_bytes"][0]:])).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "int8.pt2aot"), "wb") as f:
            f.write(blob)
        np.save(os.path.join(work, "int8_mel.npy"), mel1)
        with open(os.path.join(work, "cases.json"), "w") as f:
            json.dump([{"name": "int8", "file": "int8.pt2aot", "mel": "int8_mel.npy"}], f)
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--artifact-child", work],
                               capture_output=True, text=True, timeout=600)
        ok = child.returncode == 0 and os.path.exists(os.path.join(work, "child.json"))
        if ok:
            with open(os.path.join(work, "child.json")) as f:
                got = json.load(f)
            out = np.load(os.path.join(work, "int8.npy"))
    if not ok:
        check(False, f"(d) the int8 artifact process failed (exit {child.returncode}):\n{child.stderr[-4000:]}")
        return numbers
    g = got["int8"]
    add_launches(g["launches"])
    err, err_bf16 = rel_rms(out, direct), rel_rms(out, bf16_direct)
    bit_equal = bool(np.array_equal(out, direct))
    numbers["int8_artifact"] = {"export_s": export_s, "bytes": len(blob), "load_s": g["load_s"],
                                "launches": g["launches"], "int_mm_nodes": targets.count("aten._int_mm.default"),
                                "rel_rms_vs_direct_int8": err, "rel_rms_vs_bf16": err_bf16, "bit_equal": bit_equal,
                                "ms_cuda_events": g["ms_cuda_events"], "meta_wn_quant": g["meta"].get("wn_quant")}
    check(not got["imported_model_modules"] and g["launches"] == {"wavenet_layer": 0, "oscillator": 1}
          and targets.count("aten._int_mm.default") == 48 and g["meta"].get("wn_quant") == "int8"
          and (bit_equal or (err < 1e-2 and err < 0.1 * err_bf16)),
          f"(d) int8 artifact, batch 1 (export {export_s:.1f} s, {len(blob)} bytes, "
          f"{targets.count('aten._int_mm.default')} torch._int_mm nodes), loaded in a process without the model "
          f"code ({g['load_s']:.2f} s): against the direct int8 synthesis rel-RMS {err:.3e}, bit-equal {bit_equal} "
          f"(else < 1e-2 and < 0.1 x {err_bf16:.3e}, its distance to bf16); launches {g['launches']}; call "
          f"{g['ms_cuda_events']:.2f} ms (CUDA events)")
    return numbers


PULSE_PQMF = {"subbands": 6, "taps": 94, "cutoff_ratio": 0.0945, "beta": 9.0}
NORMMEL_ALL = dict(normalize_use_pinv=True, max_norm_fact=30.0, normalize_compressor_exp=0.5,
                   normalize_rms_num_smooth_iters=2, normalize_smooth_win_scale=1.5,
                   normalize_smooth_with_squared_win=False)
MODEL_BRANCHES = (  # [14](a): (name, pp_mod_subnet edit, mbexwn_config edit)
    ("use_sinusoid", {}, lambda mc: mc["wavetable_config"].update(use_sinusoid=True)),
    ("use_sinusoid_as_fun", {}, lambda mc: mc["wavetable_config"].update(use_sinusoid_as_fun=True)),
    ("add_subharm_chans 2", {}, lambda mc: mc["wavetable_config"].update(add_subharm_chans=2)),
    ("pulse PQMF fold", {}, lambda mc: mc.update(pulse_channels_use_pqmf=True,
                                                 pulse_channels_multi_band_config=dict(PULSE_PQMF))),
    ("no PQMF synthesis", {}, lambda mc: mc.update(pp_mod_subnet_use_pqmf=False)),
    ("ps_use_stft false", {}, lambda mc: mc.update(ps_use_stft=False)),
    ("ps_off", {}, lambda mc: mc.update(ps_off=True)),
    ("no cepstral windows", {}, lambda mc: mc.update(ps_env_order_scale=None)),
    ("no range limit", {}, lambda mc: mc.update(filter_max_db_range=None)),
    ("cepstral constraint", {}, lambda mc: mc.update(psns_use_cepstral_loss_constraint=True)),
    ("preserve energy", {}, lambda mc: mc.update(spect_filters_preserve_energy=True)),
    ("internal_fft_over 1", {}, lambda mc: mc.update(internal_fft_over=1)),
    ("NormMel, every option", {}, lambda mc: mc.update(**NORMMEL_ALL)),
    ("leaky ReLU, remove_inactive_pad_layers", {}, lambda mc: mc.update(use_prelu=False,
                                                                       remove_inactive_pad_layers=True)),
    ("equalized LR without weight norm", dict(use_weight_norm=False, use_equalized_lr=True), None),
)
K1_HELD_BRANCHES = ("add_subharm_chans 2", "pulse PQMF fold", "equalized LR without weight norm")  # [14](b)
LONG_FORM_FRAMES, LONG_FORM_CHUNK, LONG_FORM_HALO = 1600, 512, 48  # [14](c): 20 s in [8](b)'s chunks


@contextlib.contextmanager
def recording_k2(store: list):
    """A context in which the model's oscillator calls (models/mbexwn.py's
    `oscillate`) run as before and each keeps a copy of its inputs in
    `store`, so that K2 can be held against its plain version on them
    after the path ran."""
    import mbexwn_vocoder_torch.models.mbexwn as model_module

    real = model_module.oscillate

    def recording(f0, tables, *consts, phase_offset=None, return_phase=False):
        store.append((f0.clone(), tables, consts, None if phase_offset is None else phase_offset.clone()))
        return real(f0, tables, *consts, phase_offset=phase_offset, return_phase=return_phase)

    model_module.oscillate = recording
    try:
        yield store
    finally:
        model_module.oscillate = real


@contextlib.contextmanager
def recording_sharded_int8(store: list):
    """A context in which tensor parallelism's int8 layers
    (`parallel.tensor.sharded_int8_layer`) run as before and each call
    appends (x, its cond rows, its shards, dilation, activation, output)."""
    from mbexwn_vocoder_torch.parallel import tensor

    real = tensor.sharded_int8_layer

    def recording(x, cond, shards, devices, activation, dilation):
        out = real(x, cond, shards, devices, activation, dilation)
        store.append((x.clone(), None if cond is None else [c.clone() for c in cond], shards, dilation, activation,
                      out.clone()))
        return out

    tensor.sharded_int8_layer = recording
    try:
        yield store
    finally:
        tensor.sharded_int8_layer = real


def phase_branches(check, dev, synth_ms: float):
    """Phase [14]: the model's opt-in branches, SPEECH full width (C = 320,
    2 x 12 layers), random init seeded like [13](a)'s.  (a) each branch of
    `MODEL_BRANCHES`: fp32 card against the port's CPU at ROUTE_CPU_FRAMES
    (<= 1e-4 rel-RMS, the same injected noise), K1 and K2 launches per
    synthesis (24 and 1; the analytic pulse of use_sinusoid_as_fun 24 and
    0), bf16 synthesis ms by CUDA events at N_FRAMES beside the unedited
    config's in the same round.  (b) the kernels on their new inputs: K2
    against `oscillate_plain` on the subharmonic model's and the pulse-gain
    calls (audio <= 1e-5, phase bit-equal on the card and the CPU); the
    analytic pulse's phase (`oscillator_phase`) bit-equal to K2's; K1
    against `wavenet_stack_plain` on the stack inputs of the subharmonic,
    PQMF-fold and equalized-LR models (fp32 <= 1e-4, bf16 <= 2e-2); the
    pulse-gain scans card against CPU (the hold and the average, whose
    cumsum runs in fp64, bit-equal).  (c) streaming over [13](b)'s 1 x 2 grid
    of the one card, MBEXWN_TP_AXIS=model, the shipped weights:
    `synth_batched` on 20 s of long form against mesh=None (fp32 <= 1e-5,
    bf16 <= 2e-2), the reduces and the launches.  (d) the int8 mode under
    tensor parallelism on the same grid, shipped bf16, batch 1, 512
    frames: each sharded int8 layer against the unsharded int8 layer on the
    same inputs (<= 2e-3), the whole synthesis against unsharded int8
    (read), torch._int_mm calls, the reduces, ms beside unsharded int8 and
    tensor-parallel bf16.  (e) the tiny fp64 training step with both aux
    losses of the envelope (`training.parity.card_against_cpu` with the
    cepstral constraint, energy preservation and a gain-loss weight): loss
    within 1e-12, every leaf within 1e-9.  No number crosses cards: the
    host has one."""
    import copy

    import torch
    from mbexwn_vocoder_torch.nn.wavenet import int8_layer
    from mbexwn_vocoder_torch.ops import kernel_lib, quant
    from mbexwn_vocoder_torch.ops import oscillator as osc
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack_plain
    from mbexwn_vocoder_torch.parallel import StreamingSynthesizer, tensor
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh, replicate
    from mbexwn_vocoder_torch.training.parity import card_against_cpu

    numbers = {"branches": {}, "launches": {"wavenet_layer": 0, "oscillator": 0}}

    def add_launches(counts):
        for k in numbers["launches"]:
            numbers["launches"][k] += counts[k]

    # (a) each branch, card against CPU in fp32; (b)'s recordings ride on its syntheses
    mel_cpu = make_mel(ROUTE_CPU_FRAMES, 80, SEED + 170)
    mel_dev = torch.from_numpy(make_mel(N_FRAMES, 80, SEED)).to(dev)
    reference16 = branch_model({}, None, dev)
    k1_stores, k2_calls, kept = {name: {} for name in K1_HELD_BRANCHES}, [], {}
    for name, edit, config_edit in MODEL_BRANCHES:
        row = numbers["branches"][name] = {}
        model_cpu = branch_model(edit, "", "cpu", config_edit)
        model = copy.deepcopy(model_cpu).to(dev)
        blk = model.block
        noise = torch.from_numpy(np.random.RandomState(SEED + 171).randn(
            1, blk.wn_input_length(ROUTE_CPU_FRAMES), 1).astype(np.float32))
        length = ROUTE_CPU_FRAMES * model.spect_hop_size
        mel = torch.from_numpy(mel_cpu)
        with torch.inference_mode():
            y_cpu = model_cpu.infer(mel, synth_length=length, noise=noise).numpy()
            model.infer(mel.to(dev), synth_length=length, noise=noise.to(dev))  # warm-up
            torch.cuda.synchronize()
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            with recording_k1(k1_stores.get(name, {})), \
                    recording_k2(k2_calls if name == "add_subharm_chans 2" else []):
                y = model.infer(mel.to(dev), synth_length=length, noise=noise.to(dev))
                torch.cuda.synchronize()
            counts = dict(kernel_lib.launches)
        add_launches(counts)
        y = y.cpu().numpy()
        err = rel_rms(y, y_cpu)
        expected = {"wavenet_layer": 24, "oscillator": 0 if name == "use_sinusoid_as_fun" else 1}
        row.update(fp32_card_vs_cpu_rel_rms=err, launches_fp32=counts,
                   routes=sorted({getattr(blk, n).wavenet.route() for n in blk.block_names}))
        check(y.shape == y_cpu.shape and np.isfinite(y).all() and err <= 1e-4 and counts == expected,
              f"(a) SPEECH {name}, random init, fp32 {ROUTE_CPU_FRAMES} frames: card vs CPU rel-RMS {err:.3e} "
              f"(<= 1e-4); launches {counts} (expected {expected})")
        if name in K1_HELD_BRANCHES:  # their bf16 stack inputs too, for (b)
            model16 = branch_model(edit, None, dev, config_edit)
            with torch.inference_mode(), recording_k1(k1_stores[name]):
                model16.infer(mel.to(dev), synth_length=length, noise=noise.to(dev))
        if name == "use_sinusoid_as_fun":
            kept["sinusoid"] = model
        model16 = branch_model(edit, None, dev, config_edit)
        noise16 = torch.randn((1, model16.block.wn_input_length(N_FRAMES), 1), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
        ref_noise16 = torch.randn((1, reference16.block.wn_input_length(N_FRAMES), 1), device=dev,
                                  generator=torch.Generator(device=dev).manual_seed(0))
        full = N_FRAMES * model16.spect_hop_size
        with torch.inference_mode():
            y16 = model16.infer(mel_dev, synth_length=full, noise=noise16)
            ms = cuda_time_ms(lambda: model16.infer(mel_dev, synth_length=full, noise=noise16), iters=5)
            ref_ms = cuda_time_ms(lambda: reference16.infer(mel_dev, synth_length=full, noise=ref_noise16), iters=5)
        row.update(bf16_ms_cuda_events=ms, reference_bf16_ms_cuda_events=ref_ms,
                   bf16_finite=bool(torch.isfinite(y16).all()))
        check(row["bf16_finite"], f"(a) SPEECH {name}, bf16 {N_FRAMES} frames: {y16.shape[1]} finite samples, "
                                  f"synthesis {ms:.2f} ms against the unedited config's {ref_ms:.2f} ms in the "
                                  f"same round (CUDA events)")
        del model_cpu, model16
    print(f"  (a) bf16 synthesis ms (CUDA events, {N_FRAMES} frames; the unedited config's in the same round): "
          + ", ".join(f"{k} {v['bf16_ms_cuda_events']:.2f} ({v['reference_bf16_ms_cuda_events']:.2f})"
                      for k, v in numbers["branches"].items()) + f"; [5]'s synth_from_mel {synth_ms:.2f} (host clock)",
          flush=True)

    # (b) the kernels on their new inputs
    numbers["k1_vs_plain"], numbers["k1_bf16_max_abs"] = {}, 0.0
    for name, store in k1_stores.items():
        rows, k1_max_abs = hold_k1(store, wavenet_stack_plain, check, f"(b) {name} model's")
        numbers["k1_vs_plain"][name] = rows
        numbers["k1_bf16_max_abs"] = max(numbers["k1_bf16_max_abs"], k1_max_abs)
    blk = reference16.block
    wt = blk.wavetable
    consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition, wt.sample_rate)
    f0 = card_f0(reference16, mel_dev, N_FRAMES * reference16.spect_hop_size)
    rng = np.random.RandomState(SEED + 172)
    gains = [torch.from_numpy((1 + 0.3 * rng.randn(*f0.shape)).astype(np.float32)).to(dev), None]
    offset = torch.from_numpy(rng.rand(1).astype(np.float32)).to(dev)
    pulse_calls = []
    with torch.inference_mode():
        for avg in (False, True):
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            with recording_k2(pulse_calls):
                audio, held = blk.oscillate_with_pulse_gains(f0, gains, pulse_sync_gain_avg=avg, return_gain=True,
                                                             phase_offset=offset)
                torch.cuda.synchronize()
            counts = dict(kernel_lib.launches)
            add_launches(counts)
            check(counts == {"wavenet_layer": 0, "oscillator": 1} and held[1] is None
                  and bool(torch.isfinite(held[0]).all()),
                  f"(b) oscillate_with_pulse_gains ({'average' if avg else 'hold'}, return_gain, a None entry), "
                  f"{f0.shape[1]} samples: launches {counts} (one K2 for the pulse and its phase)")
    k2_rows = []
    for label, calls in (("subharmonic model", k2_calls), ("pulse gains", pulse_calls)):
        for f0_k, tables, kconsts, off in calls:
            with torch.inference_mode():
                got, phase = osc.oscillate(f0_k, tables, *kconsts, phase_offset=off, return_phase=True)
                ref, ref_phase = osc.oscillate_plain(f0_k, tables, *kconsts, phase_offset=off, return_phase=True)
                cpu_phase = osc.oscillate_plain(f0_k.cpu(), tables.cpu(), *kconsts,
                                                phase_offset=None if off is None else off.cpu(), return_phase=True)[1]
            k2_rows.append({"call": label, "samples": f0_k.numel(), "max_abs": float((got - ref).abs().max()),
                            "phase_differing_card": int((phase != ref_phase).sum()),
                            "phase_differing_cpu": int((phase.cpu() != cpu_phase).sum())})
    numbers["k2_vs_plain"] = k2_rows
    numbers["k2_max_abs"] = max(r["max_abs"] for r in k2_rows)
    check(len(k2_rows) == 3 and all(r["max_abs"] <= 1e-5 and r["phase_differing_card"] == 0
                                    and r["phase_differing_cpu"] == 0 for r in k2_rows),
          f"(b) K2 vs plain on the subharmonic model's call and the two pulse-gain calls: audio max abs "
          f"{numbers['k2_max_abs']:.3e} (<= 1e-5); phase samples differing (card, CPU) "
          f"{[(r['phase_differing_card'], r['phase_differing_cpu']) for r in k2_rows]} (all 0)")
    sblk = kept.pop("sinusoid").block
    swt = sblk.wavetable
    with torch.inference_mode():
        f0s = card_f0(reference16, mel_dev, N_FRAMES * reference16.spect_hop_size)
        diffs = []
        for off in (None, offset):
            analytic = osc.oscillator_phase(f0s, swt.sample_rate, off)
            _, k2_phase = osc.oscillate(f0s, sblk.wavetables, swt.nominalF0, swt.F0GridFactor, swt.min_transposition,
                                        swt.max_transposition, swt.sample_rate, phase_offset=off, return_phase=True)
            diffs.append(int((analytic != k2_phase).sum()))
    numbers["sinusoid_phase_differing_from_k2"] = diffs
    check(diffs == [0, 0], f"(b) use_sinusoid_as_fun's phase (oscillator_phase, no kernel) against K2's phase on "
                           f"{f0s.shape[1]} samples, without and with a phase offset: differing samples {diffs} (0)")
    with torch.inference_mode():
        phase = osc.oscillator_phase(f0, wt.sample_rate, offset)
        g = gains[0]
        hold_card = osc.pulse_sync_gain_hold(phase, g).cpu()
        avg_card = osc.pulse_sync_gain_avg(phase, g).cpu()
        hold_cpu = osc.pulse_sync_gain_hold(phase.cpu(), g.cpu())
        avg_cpu = osc.pulse_sync_gain_avg(phase.cpu(), g.cpu())
    scans = numbers["pulse_gain_scans"] = {
        "samples": int(phase.shape[1]), "hold_differing": int((hold_card != hold_cpu).sum()),
        "avg_differing": int((avg_card != avg_cpu).sum()),
        "avg_card_vs_cpu_rel_rms": rel_rms(avg_card.numpy(), avg_cpu.numpy())}
    check(scans["hold_differing"] == 0 and scans["avg_differing"] == 0,
          f"(b) pulse-gain scans card vs CPU on {scans['samples']} samples: samples differing, hold "
          f"{scans['hold_differing']}, average {scans['avg_differing']} (0, 0: the average's cumsum runs in fp64, "
          f"where these sums are exact in any order)")
    del reference16

    # (c) streaming over a model axis of cuda:0 twice
    numbers["streaming_tp"] = {"mesh": "make_mesh(n_data=1, n_model=2, devices=['cuda:0', 'cuda:0'])",
                               "cross_card": "not measured: the host has one card"}
    mell = make_mel(LONG_FORM_FRAMES, 80, SEED + 173)
    os.environ["MBEXWN_TP_AXIS"] = "model"
    try:
        for wn_dtype, label, tol in (("", "fp32", 1e-5), (None, "bf16", 2e-2)):
            model = registry_variant("SPEECH", wn_dtype, dev)
            ref = StreamingSynthesizer(model, chunk_frames=LONG_FORM_CHUNK, halo_frames=LONG_FORM_HALO,
                                       device=dev).synth_batched(mell)
            ss = StreamingSynthesizer(model, chunk_frames=LONG_FORM_CHUNK, halo_frames=LONG_FORM_HALO,
                                      mesh=make_mesh(n_data=1, n_model=2, devices=["cuda:0", "cuda:0"]))
            stacks = [getattr(ss.model.block, n).wavenet for n in ss.model.block.block_names]
            torch.cuda.synchronize()
            before = dict(tensor.counts)
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            got = ss.synth_batched(mell)
            counts = dict(kernel_lib.launches)
            add_launches(counts)
            collectives = {k: tensor.counts[k] - before[k] for k in before}
            err = rel_rms(got, ref)
            n_groups = len({(hi - lo, t0 - lo, t1 - t0) for t0, t1, lo, hi in ss._bounds(LONG_FORM_FRAMES)})
            n_layers = sum(wn.n_layers for wn in stacks)
            numbers["streaming_tp"][label] = {"rel_rms_vs_mesh_none": err, "launches": counts,
                                              "collectives": collectives, "chunk_groups": n_groups,
                                              "launches_per_device": {str(dev): counts}}
            check(got.shape == ref.shape and np.isfinite(got).all() and err <= tol
                  and counts == {"wavenet_layer": 0, "oscillator": n_groups}
                  and collectives == {"reduce_add": n_groups * n_layers, "max_reduce": 0}
                  and all(wn.tp_devices == (dev, dev) for wn in stacks),
                  f"(c) streaming synth_batched {label}, {LONG_FORM_FRAMES} frames (chunk {LONG_FORM_CHUNK}, halo "
                  f"{LONG_FORM_HALO}, "
                  f"{n_groups} chunk groups), channels split over cuda:0 twice: rel-RMS against mesh=None "
                  f"{err:.3e} (<= {tol:g}); launches {counts} on {dev} (K1 0, K2 one a group); collectives "
                  f"{collectives}; no number crosses cards")
            del model, ss

        # (d) the int8 mode under tensor parallelism, shipped bf16, batch 1
        mel1 = torch.from_numpy(make_mel(N_FRAMES, 80, SEED + 174)).to(dev)
        model = registry_variant("SPEECH", None, dev)
        plain = copy.deepcopy(model)  # built with the axis, unplaced: the unsharded layer loop
        replica = replicate(model, make_mesh(n_data=1, n_model=2, devices=["cuda:0", "cuda:0"]))[dev]
        stacks = [getattr(replica.block, n).wavenet for n in replica.block.block_names]
        noise = torch.randn((1, replica.block.wn_input_length(N_FRAMES), 1), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        full = N_FRAMES * replica.spect_hop_size
        infer = {"tp int8": lambda: replica.infer(mel1, synth_length=full, noise=noise),
                 "unsharded int8": lambda: plain.infer(mel1, synth_length=full, noise=noise)}
        os.environ[quant.QUANT_ENV] = "int8"
        records = []
        with torch.inference_mode():
            y_plain = infer["unsharded int8"]().cpu().numpy()
            infer["tp int8"]()  # warm-up: quantizes and shards the weights once
            torch.cuda.synchronize()
            whole = {}
            for wn in stacks:
                for w, shards in zip(wn.int8_weights(torch.bfloat16), wn._tp_int8_weights(torch.bfloat16)):
                    whole[id(shards)] = w
            n_mm, before = quant.int_mm_calls, dict(tensor.counts)
            kernel_lib.reset_launch_counts()  # this path's counts: 0 just before, read just after
            with recording_sharded_int8(records):
                y_tp = infer["tp int8"]().cpu().numpy()
            counts = dict(kernel_lib.launches)
            n_mm = quant.int_mm_calls - n_mm
            collectives = {k: tensor.counts[k] - before[k] for k in before}
            add_launches(counts)
            layer_errs = []
            for x, conds, shards, dil, act, out in records:
                cond = None
                if conds is not None:
                    half = [c.chunk(2, dim=-1) for c in conds]
                    cond = torch.cat([h[0] for h in half] + [h[1] for h in half], dim=-1)
                ref = int8_layer(x, cond, whole[id(shards)], dil, act)
                layer_errs.append(rel_rms(out.float().cpu().numpy(), ref.float().cpu().numpy()))
            ms = {k: cuda_time_ms(fn, iters=5) for k, fn in infer.items()}
            os.environ.pop(quant.QUANT_ENV, None)
            ms["tp bf16"] = cuda_time_ms(infer["tp int8"], iters=5)
        n_layers = sum(wn.n_layers for wn in stacks)
        numbers["int8_tp"] = {"layer_rel_rms_vs_unsharded_int8": layer_errs, "worst_layer": max(layer_errs),
                              "whole_synthesis_rel_rms_vs_unsharded_int8": rel_rms(y_tp, y_plain),
                              "int_mm_calls": n_mm, "collectives": collectives, "launches": counts,
                              "ms_cuda_events": ms}
        check(len(layer_errs) == n_layers and max(layer_errs) <= 2e-3 and np.isfinite(y_tp).all()
              and n_mm == 2 * 2 * n_layers and collectives == {"reduce_add": n_layers, "max_reduce": n_layers}
              and counts == {"wavenet_layer": 0, "oscillator": 1},
              f"(d) int8 under tensor parallelism, SPEECH shipped bf16 batch 1, {N_FRAMES} frames, cuda:0 twice: "
              f"each of its {len(layer_errs)} sharded int8 layers against the unsharded int8 layer on the same "
              f"inputs, worst rel-RMS {max(layer_errs):.3e} (<= 2e-3); the whole synthesis against unsharded int8 "
              f"{rel_rms(y_tp, y_plain):.3e} (read); torch._int_mm calls {n_mm} (2 x 2 x {n_layers}); collectives "
              f"{collectives}; launches {counts}; ms (CUDA events) " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
        del model, plain, replica
    finally:
        os.environ.pop("MBEXWN_TP_AXIS", None)
        os.environ.pop(quant.QUANT_ENV, None)

    # (e) the envelope's aux losses in a tiny fp64 training step, card against CPU
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        os.environ[var] = ""
    aux_failures, aux = card_against_cpu(dev, SEED, edits={"mbexwn_config.psns_use_cepstral_loss_constraint": True,
                                                           "mbexwn_config.spect_filters_preserve_energy": True,
                                                           "mbexwn_config.psns_gain_loss_weight": 0.3})
    numbers["aux_loss_training"] = aux
    check(not aux_failures and {"PS_cepstral_loss", "PS_gain_loss"} <= set(aux["metrics"]),
          f"(e) tiny fp64 step with the cepstral constraint and energy preservation (aux losses "
          f"{sorted(k for k in aux['metrics'] if k.startswith('PS_'))}), card vs CPU: loss rel "
          f"{aux['loss_fp64_rel']:.2e} (<= 1e-12), worst leaf {aux['worst_leaf_fp64']} {aux['worst_rel_rms_fp64']:.2e} "
          f"(<= 1e-9); failing {aux_failures}")
    return numbers


def waveglow_config() -> dict:
    """[15]'s configuration: NVIDIA's WaveGlow at its published widths with
    seeded weights, as the benchmark's `waveglow` configuration states it."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs", "waveglow.json")) as f:
        return json.load(f)


WAVEGLOW_GROUP_FRAMES = (513, 1000)  # [15](c): a batch-8 group in bucket 1024


def phase_waveglow(check, dev):
    """[15] WaveGlow (models/waveglow.py) at its published widths on the card:
    (a) the fp32 synthesis (K1's FMA route) against the plain reference's on
    the card, and the bf16 one: 96 K1 launches a synthesis, its distance to
    the reference; (b) one WN's K1 at batch 1 and 512 frames, the whole WN,
    K1's bound and its plain version; (c) PipelinedSynthesizer at batch 8 in
    bucket 1024: 96 launches a group, the group's time and peak memory."""
    import tempfile

    import torch
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.ops import kernel_lib
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer
    from tests.waveglow_reference import Reference, write_model_dir

    out, config = {}, waveglow_config()
    with tempfile.TemporaryDirectory() as tmp:
        path = write_model_dir(config, os.path.join(tmp, "waveglow"))
        ref = Reference(config, path, dev)
        mel = make_mel(64, 80, SEED + 150)
        mel_dev = torch.from_numpy(mel).to(dev)
        y_ref = ref.synth(mel_dev).cpu().numpy()[0]
        for name, dtype in (("fp32", ""), ("bf16", None)):
            if dtype is None:
                os.environ.pop("MBEXWN_WN_DTYPE", None)
            else:
                os.environ["MBEXWN_WN_DTYPE"] = dtype
            inv = MELInverter(path, device=dev, length_buckets=(64, 512, 1024))
            os.environ.pop("MBEXWN_WN_DTYPE", None)
            inv.synth_from_mel(mel)
            torch.cuda.synchronize()
            kernel_lib.reset_launch_counts()
            y = inv.synth_from_mel(mel)
            counts = dict(kernel_lib.launches)
            err = rel_rms(y, y_ref)
            out[f"{name}_rel_rms_vs_reference"], out[f"{name}_launches"] = err, counts
            n_wn = sum(wn.n_layers for wn in inv.model.WN)
            routes = sorted({wn.route() for wn in inv.model.WN})
            check(routes == ["k1"] and counts == {"wavenet_layer": n_wn, "oscillator": 0} and np.isfinite(y).all()
                  and (err <= 1e-4 if name == "fp32" else err <= 0.05),
                  f"(a) WaveGlow {name} 64 frames: routes {routes}, launches {counts} (expected {n_wn}), rel-RMS "
                  f"{err:.3e} against the fp32 reference on the card (<= {1e-4 if name == 'fp32' else 0.05:g})")
        # (b) one WN at batch 1 and 512 frames (rows 512 * 256 / 8), and at batch 8 of bucket 1024, its cond the
        # real cond conv's output: K1 against its plain version
        model = inv.model
        wn = model.WN[0]

        def wn_operands(mel_np, seed):
            cond_in = model.upsample(torch.from_numpy(mel_np).to(dev)).to(torch.bfloat16)
            g = torch.Generator(device=dev).manual_seed(seed)
            x_in = torch.randn((mel_np.shape[0], cond_in.shape[1], wn.start.in_channels), device=dev, generator=g)
            x_in = x_in * 0.6
            cond = wn.conditioning(cond_in).unflatten(-1, (wn.n_layers, 2 * wn.n_channels))
            return x_in, cond_in, wn.start(x_in.to(torch.bfloat16)), cond

        with torch.inference_mode():
            weights = wn.stack_weights(torch.bfloat16)
            x_in, cond_in, xs, cond = wn_operands(make_mel(N_FRAMES, 80, SEED + 151), SEED + 152)
            k1_ms = cuda_time_ms(lambda: wavenet_stack(xs, cond, weights, wn.dilations), iters=20)
            wn_ms = cuda_time_ms(lambda: wn(x_in, cond_in), iters=20)
            with exact_fp32():
                plain_ms = cuda_time_ms(lambda: wavenet_stack_plain(xs, cond, weights, wn.dilations), iters=5)
                err_1 = rel_rms(wavenet_stack(xs, cond, weights, wn.dilations).cpu(),
                                wavenet_stack_plain(xs, cond, weights, wn.dilations).cpu())
        B, T, C = xs.shape
        flop = B * T * C * C * (16.0 * (wn.n_layers - 1) + 14.0)
        nbytes = 2.0 * B * T * C * (1 + 2 * wn.n_layers) + 2.0 * (8 * wn.n_layers - 1) * C * C + 4.0 * B * T * C
        bound_ms = 1e3 * max(flop / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S)
        out["wn_batch1_512_frames"] = {"rows": T, "k1_ms": k1_ms, "wn_ms": wn_ms, "k1_plain_ms": plain_ms,
                                       "k1_bound_ms": bound_ms, "k1_tflops": flop / k1_ms / 1e9,
                                       "k1_vs_plain_rel_rms": err_1}
        check(err_1 <= 2e-2, f"(b) one WN (C={C}, {wn.n_layers} layers) at batch 1, {N_FRAMES} frames ({T} rows): K1 "
                             f"{k1_ms:.3f} ms ({flop / k1_ms / 1e9:.1f} TFLOP/s; bound {bound_ms:.4f} ms), the whole "
                             f"WN {wn_ms:.3f} ms, K1's plain version {plain_ms:.3f} ms; K1 vs plain rel-RMS "
                             f"{err_1:.3e} (<= 2e-2)")
        del x_in, cond_in, xs, cond
        mels8 = np.concatenate([make_mel(1024, 80, SEED + 170 + i) for i in range(8)])
        with torch.inference_mode():
            _, _, xs, cond = wn_operands(mels8, SEED + 171)
            kernel_lib.reset_launch_counts()
            with exact_fp32():
                got = wavenet_stack(xs, cond, weights, wn.dilations)
                torch.cuda.synchronize()
                launches = kernel_lib.launches["wavenet_layer"]
                err_8 = rel_rms(got.cpu(), wavenet_stack_plain(xs, cond, weights, wn.dilations).cpu())
        out["wn_batch8_bucket1024"] = {"rows": int(xs.shape[1]), "k1_vs_plain_rel_rms": err_8, "launches": launches}
        check(err_8 <= 2e-2 and launches == wn.n_layers and bool(torch.isfinite(got).all()),
              f"(b) one WN at batch 8, bucket 1024 ({xs.shape[1]} rows an utterance; cond {cond.numel() * 2 / 1e9:.2f} "
              f"GB read in place): K1 vs plain rel-RMS {err_8:.3e} (<= 2e-2), {launches} launches")
        del xs, cond, got
        # (c) serving: groups of 8 in bucket 1024
        synth = PipelinedSynthesizer(model, length_buckets=(1024,), depth=3, batch=8, device=dev)
        lengths = np.linspace(*WAVEGLOW_GROUP_FRAMES, 8).astype(int)
        mels = [make_mel(int(T), 80, SEED + 160 + i)[0] for i, T in enumerate(lengths)]
        synth.map(mels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernel_lib.reset_launch_counts()
        n_groups = 6
        t0 = time.perf_counter()
        ys = synth.map(mels * n_groups)
        group_ms = (time.perf_counter() - t0) * 1e3 / n_groups
        counts = dict(kernel_lib.launches)
        audio_s = float(np.sum(lengths)) * 256 / 22050
        out["serving_batch8"] = {"group_ms_host": group_ms, "audio_s_per_s": audio_s / group_ms * 1e3,
                                 "launches_per_group": counts["wavenet_layer"] / n_groups,
                                 "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        check(counts["wavenet_layer"] == 96 * n_groups and all(np.isfinite(y).all() for y in ys),
              f"(c) PipelinedSynthesizer batch 8, bucket 1024, {n_groups} groups: {group_ms:.1f} ms a group "
              f"({audio_s / group_ms * 1e3:.1f} audio-s/s, host clock), {counts['wavenet_layer'] / n_groups:.0f} "
              f"K1 launches a group, peak {out['serving_batch8']['peak_memory_gb']:.2f} GB")
        out["launches"] = {k: out["fp32_launches"][k] + out["bf16_launches"][k] + counts[k] for k in counts}
        out["launches"]["wavenet_layer"] += out["wn_batch8_bucket1024"]["launches"]
        del inv, model, synth, ref
    return out


def checker(failures: list):
    """A phase's `check(ok, what)`: prints the line and records a failure."""

    def check(ok: bool, what: str):
        print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            failures.append(what)

    return check


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
    check = checker(failures)

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

    # ---- 2. K1 vs plain
    print("[2] K1 wavenet_layer vs plain (blocks 0 and 1, 512 frames)", flush=True)
    k1_err = {}
    for model_id in ("SPEECH", "VOICE"):
        inv = inverter(model_id, "")
        for block_index in range(len(inv.model.block.block_names)):
            for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
                x, cond, weights, dils, _ = stack_inputs(inv.model, mel, block_index, dtype, dev)
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
    x, cond, weights, dils, _ = stack_inputs(inv.model, mel, 0, torch.bfloat16, dev)
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
        x, cond, weights, dils, _ = stack_inputs(inv.model, mel, bi, torch.bfloat16, dev)
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

    # ---- 7. serving
    print("[7] serving (SPEECH, shipped bf16, full width)", flush=True)
    serving = phase_serving(inverter, check, dev)
    k1_max_abs = max(k1_max_abs, serving["kernel_checks"]["k1_bf16_max_abs"])
    k2_err = max(k2_err, serving["kernel_checks"]["k2_max_abs"])

    # ---- 8. streaming
    print("[8] streaming (SPEECH, full width)", flush=True)
    t0 = time.perf_counter()
    streaming = phase_streaming(inverter, check, dev)
    streaming["seconds"] = time.perf_counter() - t0
    streaming["card"] = card
    k1_max_abs = max(k1_max_abs, streaming["k1_bf16_max_abs"])
    # ---- 9. training
    print("[9] training (the differentiable route; SPEECH full width)", flush=True)
    t0 = time.perf_counter()
    training = phase_training(check, dev)
    training["seconds"] = time.perf_counter() - t0
    training["card"] = card
    print(f"  phase [9] {training['seconds']:.1f} s", flush=True)
    # ---- 10. the training CLI, pretraining and adversarial training
    print("[10] training CLI (cli.train), pretraining, adversarial (SPEECH full width)", flush=True)
    t0 = time.perf_counter()
    cli_run = phase_training_cli(check, dev, training["full_width"]["step_ms_cuda_events"])
    cli_run["seconds"] = time.perf_counter() - t0
    cli_run["card"] = card
    k1_max_abs = max([k1_max_abs] + [v["max_abs"] for k, v in cli_run.get("cli", {}).get("k1_vs_plain", {}).items()
                                     if k.endswith("bfloat16")])
    k2_err = max(k2_err, cli_run.get("cli", {}).get("k2_vs_plain_max_abs", 0.0))
    print(f"  phase [10] {cli_run['seconds']:.1f} s", flush=True)
    # ---- 11. the parallel layer
    print("[11] parallel: data-parallel training and synthesis over a mesh (SPEECH full width)", flush=True)
    t0 = time.perf_counter()
    parallel = phase_parallel(inverter, check, dev, serving, streaming, training, cli_run)
    parallel["seconds"] = time.perf_counter() - t0
    parallel["card"] = card
    k1_max_abs = max([k1_max_abs, parallel.get("k1_bf16_max_abs", 0.0)]
                     + [v["max_abs"] for k, v in parallel.get("cli", {}).get("k1_vs_plain", {}).items()
                        if k.endswith("bfloat16")])
    k2_err = max(k2_err, parallel.get("cli", {}).get("k2_vs_plain_max_abs", 0.0))
    print(f"  phase [11] {parallel['seconds']:.1f} s", flush=True)
    # ---- 12. the AOT export path, remat training, observability
    print("[12] export, remat, observability (SPEECH full width)", flush=True)
    t0 = time.perf_counter()
    slice9 = {"export": phase_export(inverter, check, dev, synth_ms)}
    slice9["remat"] = phase_remat(check, dev, training)
    slice9["observability"] = phase_observability(inverter, check, dev, synth_ms)
    slice9["seconds"] = time.perf_counter() - t0
    slice9["card"] = card
    print(f"  phase [12] {slice9['seconds']:.1f} s", flush=True)
    # ---- 13. every route of the WaveNet stack: the branches, tensor parallelism, the int8 mode and artifact
    print("[13] routes: the branches K1 does not take, tensor parallelism, int8 (SPEECH full width)", flush=True)
    t0 = time.perf_counter()
    routes = phase_routes(inverter, check, dev, synth_ms, serving)
    routes["seconds"] = time.perf_counter() - t0
    routes["card"] = card
    print(f"  phase [13] {routes['seconds']:.1f} s", flush=True)
    # ---- 14. the model's opt-in branches, streaming and int8 over a model axis, the aux losses
    print("[14] branches: excitation, envelope, NormMel, subnets; streaming and int8 over a model axis "
          "(SPEECH full width)", flush=True)
    t0 = time.perf_counter()
    branches = phase_branches(check, dev, synth_ms)
    branches["seconds"] = time.perf_counter() - t0
    branches["card"] = card
    k1_max_abs = max(k1_max_abs, branches.get("k1_bf16_max_abs", 0.0))
    k2_err = max(k2_err, branches.get("k2_max_abs", 0.0))
    print(f"  phase [14] {branches['seconds']:.1f} s", flush=True)
    print("[15] WaveGlow (12 flows x 8-layer WN at C=256, per-layer cond on K1)", flush=True)
    t0 = time.perf_counter()
    waveglow = phase_waveglow(check, dev)
    waveglow["seconds"] = time.perf_counter() - t0
    print(f"  phase [15] {waveglow['seconds']:.1f} s", flush=True)

    # each path's counts, set to 0 just before it and read just after: [4]'s synthesis, one pass of each
    # long-form mode ([8](b), shipped model), the live streams ([8](c)), the trained and the reloaded
    # model's syntheses ([9](d)), the CLI export's synthesis ([10](a)), and [11]'s: the data-parallel CLI
    # export's synthesis and the bf16 mesh passes of BatchSynthesizer and synth_batched; [12]'s: one call of
    # each loaded artifact (in the artifact process) and the syntheses under profile_trace, debug_nans and
    # dump_controls; [13]'s: each branch model's and the gtu reference's fp32 synthesis, the standalone
    # per-layer stack, the tensor-parallel and int8 syntheses, and one call of the int8 artifact; [14]'s:
    # each model branch's fp32 synthesis, the two pulse-gain calls, the streaming passes over a model axis
    # and the int8 synthesis under tensor parallelism
    launches = {k: main_launches[k] + streaming["long_form"]["launches"][k] + streaming["live"]["launches"][k]
                + training["trained_synthesis_launches"][k] + training["reloaded_synthesis_launches"][k]
                + cli_run["cli"]["synthesis_launches"][k] + parallel["launches"][k]
                + slice9["export"].get("launches", {}).get(k, 0) + slice9["observability"]["launches"][k]
                + routes["launches"][k] + branches["launches"][k] + waveglow["launches"][k] for k in main_launches}

    if failures:
        print(f"chip_smoke: FAIL {len(failures)} check(s): {failures}", flush=True)
        return 1

    kernels = [
        {"name": "wavenet_layer", "route": "cuda", "source": "mbexwn_vocoder_torch/csrc/wavenet_layer.cu",
         "replaces": "mbexwn_vocoder_tpu/ops/pallas_wavenet.py:106", "launches": launches["wavenet_layer"],
         "max_abs_err": k1_max_abs, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_bound_by, "library_ms": None},
        {"name": "oscillator", "route": "cuda", "source": "mbexwn_vocoder_torch/csrc/oscillator.cu",
         "replaces": "mbexwn_vocoder_tpu/ops/pallas_oscillator.py:49", "launches": launches["oscillator"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": library_ms},
    ]
    print(f"summary: SPEECH bf16 batch 1 {N_FRAMES} frames: synthesis {synth_ms:.2f} ms = "
          f"{audio_s / (synth_ms / 1e3):.1f} audio-s/s, device idle share {idle:.3f}, {n_activities} device "
          f"activities; K1 {k1_ms:.3f} ms (bound {k1_bound:.4f}), K2 {k2_ms:.5f} ms (bound {k2_bound:.5f}); "
          f"training step SPEECH batch {training['full_width']['batch']} "
          f"{training['full_width']['step_ms_cuda_events']:.2f} ms (WaveNet bound "
          f"{training['full_width']['wavenet_bound_ms']:.2f}), peak {training['full_width']['peak_memory_gb']:.2f} GB; "
          f"CLI step {cli_run['cli']['step_ms_host_median_3_10']:.2f} ms (host), idle share "
          f"{cli_run['cli']['idle_share']:.3f}; all checks passed", flush=True)
    print("serving: " + json.dumps(serving), flush=True)
    print("streaming: " + json.dumps(streaming), flush=True)
    print("training: " + json.dumps(training), flush=True)
    print("training_driver: " + json.dumps(cli_run), flush=True)
    print("parallel: " + json.dumps(parallel), flush=True)
    print("export_remat_observability: " + json.dumps(slice9, default=str), flush=True)
    print("routes: " + json.dumps(routes, default=str), flush=True)
    print("branches: " + json.dumps(branches, default=str), flush=True)
    print("waveglow: " + json.dumps(waveglow, default=str), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main_waveglow() -> int:
    """`chip_smoke.py --waveglow`: [1]'s build, then [15] alone."""
    import torch
    from mbexwn_vocoder_torch.ops import kernel_lib

    dev, failures = torch.device("cuda:0"), []
    check = checker(failures)
    kernel_lib.library()
    print("[15] WaveGlow (12 flows x 8-layer WN at C=256, per-layer cond on K1)", flush=True)
    print("waveglow: " + json.dumps(phase_waveglow(check, dev), default=str), flush=True)
    print(f"chip_smoke --waveglow: {'FAIL ' + str(failures) if failures else 'ok'}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--artifact-child":
        sys.exit(artifact_child(sys.argv[2]))
    if sys.argv[1:] == ["--waveglow"]:
        sys.exit(main_waveglow())
    sys.exit(main())
