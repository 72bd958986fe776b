"""Frozen operation and byte counts, and the card's published peaks.

The yardstick of the per-layer metrics: a later change to the program
cannot move it.  `k1_work` and `synthesis_flops` are copies of the port's
counts (chip_smoke.py `k1_work`, observability.py `synthesis_flops`,
itself the JAX package's count, term for term), written against a
configuration file's dict instead of a built model.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def k1_work(B: int, T: int, C: int, n_layers: int) -> Tuple[float, float]:
    """(operations, bytes) of one gated WaveNet stack of n_layers on B x T rows
    of C channels: per row 16 C^2 FLOP a layer (the 3-tap C -> 2C conv and the
    C -> 2C res/skip product), 14 C^2 for the skip-only last layer; bf16 x,
    cond and weights read once, the fp32 skip sum written once."""
    flop = B * T * C * C * (16.0 * (n_layers - 1) + 14.0)
    weight_elems = n_layers * 8 * C * C - C * C
    return flop, 2.0 * B * T * C + 2.0 * B * T * 2 * C + 2.0 * weight_elems + 4.0 * B * T * C


def k2_bytes(B: int, T: int, n_wavetable: int, n_grid: int) -> float:
    """Bytes of one oscillator stage: F0 in and audio out (fp32), the tables once."""
    return 8.0 * B * T + 4.0 * n_wavetable * n_grid


def roofline_seconds(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def _subnet_flops(specs, T: int, cin: int, final_channels: int) -> int:
    f, t = 0, T
    for spec in specs:
        ks, nf = spec[0], spec[1]
        up, linear = 1, False
        if len(spec) > 2:
            linear = isinstance(spec[2], str)
            up = int(spec[2][1:]) if linear else int(spec[2])
        # a sub-pixel conv computes all `up` phases at the input rate
        f += 2 * t * cin * nf * ks * (up if up > 1 and not linear else 1)
        t *= up
        cin = nf
    f += 2 * t * cin * final_channels
    return f


def synthesis_flops(config: Dict, T_mel: int, batch: int = 1) -> Dict:
    """Analytic FLOP count of one synthesis of T_mel frames: subnets, WaveNet
    stacks, post net, PQMF, the oscillator's cross-fade and the rDFTs of the
    envelope and the STFT/iSTFT (the port's `observability.synthesis_flops`)."""
    pre, mb = config["preprocess_config"], config["mbexwn_config"]
    hop, n_mels, sr = pre["hop_size"], pre["mel_channels"], pre["sample_rate"]
    subbands = mb["multi_band_config"]["subbands"]
    ups = mb["pp_mod_subnet_upsampling_factors"]
    stp = (hop // subbands) * mb["pulse_channels"] // _prod(ups)
    t12k = T_mel * stp
    wn = mb["pp_mod_subnet"]
    C, L, n_out = wn["n_channels"], wn["n_layers"], wn["n_out_channels"]
    wn_in = mb["pulse_channels"] + (1 if mb["pp_mod_subnet_noise_channel_sigma"] else 0)
    b = {"pp_subnet": _subnet_flops(mb["pp_subnet"], T_mel, n_mels, 1),
         "ps_subnet": _subnet_flops(mb["ps_subnet"], T_mel, n_mels, mb["ps_max_ceps_coefs"])}
    f, t = 0, t12k // mb["pulse_channels"]
    for up in ups:
        f += 2 * t * wn_in * C
        for i in range(L):
            f += 2 * t * C * 2 * C * 3 + 2 * t * C * (2 if i < L - 1 else 1) * C
        f += 2 * t * C * n_out + 2 * T_mel * n_mels * 2 * C * wn["cond_kernel_size"]
        if up > 1:
            f += 2 * t * n_out * n_out * up * 3
            t *= up
    b["wavenet"] = f
    b["post_pqmf"] = 2 * t * subbands * subbands + 2 * T_mel * hop * subbands * (mb["multi_band_config"]["taps"] + 1)
    wt = mb["wavetable_config"]
    pulse_rate = sr / mb["pulse_rate_factor"]
    period = 1 << math.ceil(math.log2(math.ceil(wt["wt_oversampling"] * pulse_rate / wt["nominalF0"])))
    n_grid = int(math.ceil(math.log(wt["maxF0"] / (wt["wt_oversampling"] * pulse_rate / period))
                           / math.log(wt["F0GridFactor"]))) + 1
    b["oscillator"] = 2 * t12k * (period + 1) * n_grid
    win = 4 * hop
    fft = 1 << math.ceil(math.log2(max(win, 16)))
    K = fft // 2 + 1
    b["envelope_rdft"] = 2 * T_mel * mb["ps_max_ceps_coefs"] * K * 2
    b["stft_istft"] = 2 * (T_mel + 2) * win * K * 2 * 2
    total = batch * sum(b.values())
    return {"flops_per_call": total, "breakdown": {k: batch * v for k, v in b.items()}}


def k1_flops_per_synthesis(config: Dict, T_mel: int) -> float:
    """The operations of every WaveNet stack of one synthesis (k1_work summed
    over the blocks at their rows)."""
    pre, mb = config["preprocess_config"], config["mbexwn_config"]
    wn = mb["pp_mod_subnet"]
    t = T_mel * (pre["hop_size"] // mb["multi_band_config"]["subbands"])
    t = t * mb["pulse_channels"] // int(_prod(mb["pp_mod_subnet_upsampling_factors"])) // mb["pulse_channels"]
    total = 0.0
    for up in mb["pp_mod_subnet_upsampling_factors"]:
        total += k1_work(1, t, wn["n_channels"], wn["n_layers"])[0]
        t *= up
    return total


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= int(x)
    return p
