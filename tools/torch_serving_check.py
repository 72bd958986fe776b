#!/usr/bin/env python3
"""Split the host's time in the serving modes of the PyTorch port on one
NVIDIA GPU:

    python3 tools/torch_serving_check.py [--passes N]

SPEECH's registry model in its shipped bf16 mode, chip_smoke.py's phase [7]
request set (24 requests of 100-1000 frames, 6 in each of the buckets
128/256/512/1024, in runs of one bucket).  Modes: the blocking loop
(`MELInverter.synth_from_mel` per request), PipelinedSynthesizer at batch 1
with depth 1, 2 and 3, and at batch 8 with depth 3 (chip_smoke.py [7] runs
depth 3 only).  Passes of the modes are interleaved (every mode once per
round, --passes rounds) so that a drift of the shared host does not fall on
one mode; each pass's wall time is printed and the median per mode, with the
page-locked host allocations (cudaHostAlloc, `torch.cuda.host_memory_stats`)
a pass made after warm-up.  Then one pass of each mode under torch.profiler:
the device busy time and the host's self time in the PyTorch ops and CUDA
runtime calls that take the most of it.  Needs no JAX.  The last line is
one JSON object.
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
from chip_smoke import device_activity, serving_requests  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

    if not torch.cuda.is_available():
        print("torch_serving_check: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0)
    inv = MELInverter("SPEECH")
    mels = serving_requests(inv.mel_channels)
    audio_s = sum(m.shape[1] for m in mels) * inv.hop_size / inv.srate
    modes = {"blocking": lambda: [inv.synth_from_mel(m) for m in mels]}
    for depth in (1, 2, 3):
        ps = PipelinedSynthesizer(inv.model, inv.length_buckets, depth=depth, batch=1)
        modes[f"pipelined batch 1 depth {depth}"] = lambda ps=ps: ps.map(mels)
    ps8 = PipelinedSynthesizer(inv.model, inv.length_buckets, depth=3, batch=8)
    modes["pipelined batch 8 depth 3"] = lambda: ps8.map(mels)

    for fn in modes.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    walls = {name: [] for name in modes}
    host_allocs = {name: 0 for name in modes}
    for _ in range(args.passes):
        for name, fn in modes.items():
            torch.cuda.synchronize()
            allocs = torch.cuda.host_memory_stats().get("num_host_alloc", 0)
            t0 = time.perf_counter()
            fn()
            walls[name].append(1e3 * (time.perf_counter() - t0))
            host_allocs[name] += torch.cuda.host_memory_stats().get("num_host_alloc", 0) - allocs
    result = {"card": card, "requests": len(mels), "audio_s": audio_s, "modes": {}}
    print(f"{card}: {len(mels)} requests, {audio_s:.2f} s of audio, {args.passes} interleaved passes")
    for name, fn in modes.items():
        med = float(np.median(walls[name]))
        busy_ms, n_act, _ = device_activity(fn)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[: args.top]
        allocs = host_allocs[name] / args.passes
        result["modes"][name] = {"wall_ms_median": med, "wall_ms": walls[name], "audio_s_per_s": audio_s / med * 1e3,
                                 "device_busy_ms": busy_ms, "device_activities": n_act,
                                 "pinned_allocations_per_pass": allocs,
                                 "host_self_ms": {e.key: e.self_cpu_time_total / 1e3 for e in rows}}
        print(f"  {name}: median {med:.1f} ms ({', '.join(f'{w:.1f}' for w in walls[name])}) = "
              f"{audio_s / med * 1e3:.1f} audio-s/s; device busy {busy_ms:.2f} ms in {n_act} activities; "
              f"pinned host allocations per pass {allocs:g}")
        for e in rows:
            print(f"      {e.self_cpu_time_total / 1e3:9.3f} ms host {e.count:6d}x  {e.key[:70]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
