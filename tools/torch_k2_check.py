#!/usr/bin/env python3
"""Time the oscillator stage of the PyTorch port on one NVIDIA GPU, as the
model runs it (`MBExWN.oscillate`: F0 in, excitation out), for one source
tree: this checkout, or another commit's tree unpacked with `git archive`:

    python3 tools/torch_k2_check.py [--root DIR]

SPEECH's registry model, batch 1, a 512-frame utterance's F0 (76,800
samples at 12 kHz, a glide over 80-300 Hz).  Prints, per call of the stage:
the device activities (kernels and copies) and their summed device time
under torch.profiler, the oscillator kernel's own device time there, and
the stage's time by CUDA events two ways: device-paced (a spin kernel
holds the card while the host enqueues every call, so the calls run back
to back; fails if the host was not done in time) and as enqueued (events
around back-to-back calls, which includes the host's pace when the host is
the slower side).  Works with any tree of the port that has
`MBExWN.oscillate`; needs no JAX.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).absolute().parent.parent))
from chip_smoke import device_time_ms  # noqa: E402  (before --root can shadow this checkout)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).absolute().parent.parent),
                    help="the tree whose mbexwn_vocoder_torch is timed")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).absolute()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_k2_check: FAIL no CUDA device", file=sys.stderr)
        return 2
    from mbexwn_vocoder_torch.mel_inverter import MELInverter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    blk = MELInverter("SPEECH", device="cuda").model.block
    n = 512 * blk.spect_to_pulse_upsampling_factor
    f0 = torch.from_numpy(np.linspace(80.0, 300.0, n, dtype=np.float32)[None]).cuda()

    def stage():
        return blk.oscillate(f0)

    with torch.inference_mode():
        for _ in range(5):
            stage()
        torch.cuda.synchronize()
        reps = 20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                stage()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if not events:
            print("torch_k2_check: FAIL the profiler recorded no device activity", file=sys.stderr)
            return 1
        busy_us = sum(ev.time_range.end - ev.time_range.start for ev in events)
        osc = [ev.time_range.end - ev.time_range.start for ev in events if "oscillat" in ev.name]
        result = {"root": args.root, "card": card, "samples": n, "device_activities_per_call": len(events) / reps,
                  "device_busy_ms_per_call": busy_us / 1e3 / reps,
                  "oscillator_kernel_ms": float(np.mean(osc)) / 1e3 if osc else None}
        print(f"  {card}: {n} samples; {result['device_activities_per_call']:.1f} device activities per call, "
              f"{result['device_busy_ms_per_call']:.5f} ms busy; oscillator kernel "
              f"{result['oscillator_kernel_ms']} ms", flush=True)
        # as few calls as keep the launch queue from filling up: the stage may be a dozen launches
        result["stage_ms_device_paced"] = device_time_ms(stage, 20)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            stage()
        stop.record()
        torch.cuda.synchronize()
        result["stage_ms_as_enqueued"] = start.elapsed_time(stop) / args.iters
    print(f"  stage {result['stage_ms_device_paced']:.5f} ms device-paced, {result['stage_ms_as_enqueued']:.5f} ms "
          f"as enqueued", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
