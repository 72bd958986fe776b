"""Frozen operation and byte counts of WaveGlow (configs/waveglow.json), the
yardstick of the waveglow-offline cell's per-layer metrics: copies of the
port's counts (observability.py `waveglow_flops`, term for term) written
against a configuration file's dict, so a later change to the program
cannot move them."""
from __future__ import annotations

from typing import Dict, Tuple

UPSAMPLE_KERNEL = 1024  # glow.py's ConvTranspose1d(n_mel, n_mel, 1024, stride=256)


def k1_work_per_layer_cond(B: int, T: int, C: int, n_layers: int) -> Tuple[float, float]:
    """(operations, bytes) of one gated WaveNet stack with per-layer
    conditioning on B x T rows of C channels: per row 16 C^2 FLOP a layer,
    14 C^2 for the skip-only last (as `counts.k1_work`); bf16 x and weights
    read once, the n_layers cond slabs (2C bf16 a row each) read once, the
    fp32 skip sum written once."""
    flop = B * T * C * C * (16.0 * (n_layers - 1) + 14.0)
    weight_elems = n_layers * 8 * C * C - C * C
    return flop, 2.0 * B * T * C + 2.0 * B * T * 2 * C * n_layers + 2.0 * weight_elems + 4.0 * B * T * C


def _flows(wg: Dict):
    """(n_half, remaining channels) of each flow, in flow order."""
    n_half, n_rem = wg["n_group"] // 2, wg["n_group"]
    out = []
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            n_half -= wg["n_early_size"] // 2
            n_rem -= wg["n_early_size"]
        out.append((n_half, n_rem))
    return out


def synthesis_flops(config: Dict, T_mel: int, batch: int = 1) -> Dict:
    """Analytic FLOP count of one WaveGlow synthesis of T_mel frames, 2 per
    multiply-add: the transposed-conv upsampler (every frame against the
    whole kernel), and per flow at T_mel * hop / n_group rows the WN (start,
    the per-layer cond conv, 16 C^2 a row and layer and 14 C^2 for the last,
    end), the coupling (3 a row and channel) and W^-1."""
    pre, wg = config["preprocess_config"], config["waveglow_config"]
    n_mel, G = pre["mel_channels"], wg["n_group"]
    C, L = wg["WN_config"]["n_channels"], wg["WN_config"]["n_layers"]
    rows = T_mel * pre["hop_size"] // G
    b = {"upsample": 2 * T_mel * n_mel * n_mel * UPSAMPLE_KERNEL,
         "wavenet_layers": 0, "wavenet_cond": 0, "wavenet_start_end": 0, "coupling": 0}
    for h, c in _flows(wg):
        b["wavenet_layers"] += rows * C * C * (16 * (L - 1) + 14)
        b["wavenet_cond"] += 2 * rows * n_mel * G * 2 * C * L
        b["wavenet_start_end"] += 2 * rows * h * C + 2 * rows * C * 2 * h
        b["coupling"] += 3 * rows * h + 2 * rows * c * c
    return {"flops_per_call": batch * sum(b.values()), "breakdown": {k: batch * v for k, v in b.items()}}
