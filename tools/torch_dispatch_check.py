#!/usr/bin/env python3
"""Time batch-1 synthesis and the two kernels of the PyTorch port on one
NVIDIA GPU, for one source tree: this checkout, or another commit's tree
unpacked with `git archive`:

    python3 tools/torch_dispatch_check.py [--root DIR] [--reps N]

SPEECH's registry model as shipped (bf16), batch 1, the 512-frame mel of
`chip_smoke.py` (seed 1234): `MELInverter.synth_from_mel` on the host
clock (the median of N calls after 5 warm-up calls; each call ends in the
audio's readback), K1 on both WaveNet blocks' stack inputs by CUDA events
(`wavenet_stack`, the sum of the two), and K2 on the oscillator's F0
device-paced (`chip_smoke.device_time_ms`).  `chip_smoke.py` [5] takes the
same readings; this one runs alone, so a comparison of two trees in one
chip call (parent, change, change, parent) reads the host cost of the
kernels' entry points, which is what the ops' dispatch adds at batch 1.
Needs no JAX.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).absolute().parent.parent))
from chip_smoke import SEED, cuda_time_ms, device_time_ms, make_mel, stack_inputs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).absolute().parent.parent),
                    help="the tree whose mbexwn_vocoder_torch is timed")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).absolute()))
    import torch

    if not torch.cuda.is_available():
        print("torch_dispatch_check: FAIL no CUDA device", file=sys.stderr)
        return 2
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.ops.oscillator import oscillate
    from mbexwn_vocoder_torch.ops.precision import exact_fp32
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    dev = torch.device("cuda")
    inv = MELInverter("SPEECH", device=dev)
    mel = make_mel(512, 80, SEED)
    for _ in range(5):
        inv.synth_from_mel(mel)
    torch.cuda.synchronize()
    synth = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        inv.synth_from_mel(mel)
        synth.append(1e3 * (time.perf_counter() - t0))
    blk = inv.model.block
    k1_ms, f0 = 0.0, None
    for bi in range(len(blk.block_names)):
        x, cond, weights, dils, f0 = stack_inputs(inv.model, mel, bi, torch.bfloat16, dev)
        with torch.inference_mode(), exact_fp32():
            k1_ms += cuda_time_ms(lambda: wavenet_stack(x, cond, weights, dils), iters=10)
    wt = blk.wavetable
    consts = (wt.nominalF0, wt.F0GridFactor, wt.min_transposition, wt.max_transposition, wt.sample_rate)
    with torch.inference_mode():
        k2_ms = device_time_ms(lambda: oscillate(f0, blk.wavetables, *consts), iters=200)
    out = {"root": str(Path(args.root).absolute()), "card": card, "synth_ms_host_median": float(np.median(synth)),
           "synth_ms_host": synth, "k1_ms_per_synthesis": k1_ms, "k2_ms_device_paced": k2_ms}
    print(f"{card}: synthesis {out['synth_ms_host_median']:.3f} ms (host clock, median of {args.reps}), K1 "
          f"{k1_ms:.3f} ms, K2 {k2_ms:.5f} ms device-paced", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
