"""WaveGlow (Prenger, Valle & Catanzaro, "WaveGlow: A Flow-based Generative
Network for Speech Synthesis", ICASSP 2019, arXiv:1811.00002; NVIDIA's
github.com/NVIDIA/waveglow `glow.py`): mel -> waveform by inverting a flow of
`n_flows` affine couplings, each conditioned by a WaveNet-like `WN` on the
upsampled mel.

`WaveGlow.infer` follows glow.py's `WaveGlow.infer` term for term:
- the mel is upsampled to the audio rate by `ConvTranspose1d(n_mel, n_mel,
  1024, stride=256)`, trimmed by kernel - stride, and unfolded into groups
  of `n_group` samples: (B, T * hop / n_group, n_mel * n_group);
- z (the remaining channels) times sigma; for k = n_flows - 1 ... 0:
  `WN[k]` on the first half, b and s its output's halves,
  x_1 = (x_1 - b) / exp(s), then the inverse of the flow's 1x1 conv W_k;
  after every flow k > 0 with k % n_early_every == 0, sigma times an early
  z of `n_early_size` channels is prepended;
- the n_group channels are interleaved into samples.

Departures from glow.py: activations are channels-last (B, T, C), so a
unfold is a reshape and W_k^-1 a product on the rows; each WN is the port's
`WaveNetAE` with per-layer conditioning (one 1-wide cond conv of
2 * C * n_layers channels, dilations 2^i, k=3 SAME, the gtu gate, res/skip
1x1 convs with a skip-only last layer), which K1 runs
(`WaveNetAE.route() == "k1"`), in `wn_compute_dtype` (bf16 as configured;
NVIDIA's own inference runs fp16); the upsampler, the couplings, W_k^-1 (the
fp32 inverse of W_k, made once per weight set) and the noise stay fp32.  The
noise is the model's own draw from a generator seeded 0 on the device
(first the initial z, then each early z, each (B, channels, T) as glow.py
shapes them), or handed in as `noise` (B, T * hop / n_group, n_group): the
initial z's channels, then the early z's in the order they are prepended.

Weights (`weights.npz` in a model directory, read by the normal loader:
`MELInverter(dir)`): JAX-layout paths as the registry's, `upsample/kernel`
(1024, n_mel_in, n_mel_out) and `upsample/b`; `WN/<k>/<conv>/{v, g, b}` for
the weight-normalised WN convs (start, cond, conv1D_<i>, res_skip_<i>) and
`WN/<k>/end/{kernel, b}`; `convinv/<k>/kernel` (1, c_in, c_out), W_k
transposed.

The flows are non-causal and carry no state between chunks, so a WaveGlow
model has no streaming form (`parallel.StreamingSynthesizer` refuses it).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.wavenet import WaveNetAE
from ..observability import MODEL_WAVENET, WAVEGLOW_COUPLING, WAVEGLOW_UPSAMPLE, span
from ..ops.precision import exact_fp32
from .mbexwn import _dtype_pref

UPSAMPLE_KERNEL = 1024  # glow.py's ConvTranspose1d(n_mel, n_mel, 1024, stride=256): the stride is the hop


class WaveGlowUpsample(nn.Module):
    """glow.py's `upsample` with its trim and the group unfold: (B, T, n_mel)
    log-mel -> (B, T * stride / n_group, n_mel * n_group) fp32, channel
    m * n_group + j holding mel channel m at sample j of the group.  `weight`
    is OIW (n_mel_out, n_mel_in, kernel): y[t * stride + w, o] +=
    x[t, i] * weight[o, i, w]."""

    def __init__(self, n_mel: int, kernel_size: int, stride: int, n_group: int):
        super().__init__()
        self.kernel_size, self.stride, self.n_group = kernel_size, stride, n_group
        self.weight = nn.Parameter(torch.zeros(n_mel, n_mel, kernel_size))
        self.bias = nn.Parameter(torch.zeros(n_mel))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        B, T, n_mel = mel.shape
        y = F.conv_transpose1d(mel.transpose(1, 2), self.weight.transpose(0, 1), self.bias, stride=self.stride)
        y = y[:, :, : y.shape[2] - (self.kernel_size - self.stride)]  # glow.py's trim of the conv's tail
        G = self.n_group
        return y.unfold(2, G, G).permute(0, 2, 1, 3).reshape(B, y.shape[2] // G, n_mel * G)


class InvertibleConv(nn.Module):
    """glow.py's `Invertible1x1Conv`: W (c, c), OIW (c, c, 1); synthesis
    applies its inverse, made in fp32 once per weight set (`inverse`)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.eye(c)[:, :, None].clone())
        self._inv = None

    def inverse(self) -> torch.Tensor:
        key = (self.weight.data_ptr(), self.weight._version, self.weight.device)
        if self._inv is None or self._inv[0] != key:
            self._inv = (key, torch.linalg.inv(self.weight.detach()[:, :, 0].float()))
        return self._inv[1]


class WaveGlow(nn.Module):
    """The model: `infer(mel (B, T, n_mel), synth_length, noise=None)` ->
    (B, synth_length) audio.  Its weights are its own (no `block`)."""

    streamable = False  # non-causal flows, no state carried between chunks: StreamingSynthesizer refuses it

    def __init__(self, waveglow_config: Dict, preprocess_config: Dict):
        super().__init__()
        cfg = waveglow_config
        self.sample_rate = preprocess_config["sample_rate"]
        self.spect_hop_size = preprocess_config["hop_size"]
        self.mel_channels = preprocess_config["mel_channels"]
        if cfg["n_mel_channels"] != self.mel_channels:
            raise ValueError(f"WaveGlow: n_mel_channels {cfg['n_mel_channels']} != the mel's {self.mel_channels}")
        self.n_flows, self.n_group = cfg["n_flows"], cfg["n_group"]
        self.n_early_every, self.n_early_size = cfg["n_early_every"], cfg["n_early_size"]
        self.sigma = float(cfg.get("sigma", 1.0))
        if self.n_group % 2 or self.spect_hop_size % self.n_group:
            raise ValueError(f"WaveGlow: n_group {self.n_group} must be even and divide the hop size "
                             f"{self.spect_hop_size} (the upsampler's stride)")
        self.wn_compute_dtype = _dtype_pref("MBEXWN_WN_DTYPE", cfg.get("wn_compute_dtype"))  # env > config
        wn = cfg["WN_config"]
        self.upsample = WaveGlowUpsample(self.mel_channels, UPSAMPLE_KERNEL, self.spect_hop_size, self.n_group)
        self.WN = nn.ModuleList()
        self.convinv = nn.ModuleList()
        n_half, n_remaining = self.n_group // 2, self.n_group
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                n_half -= self.n_early_size // 2
                n_remaining -= self.n_early_size
            self.convinv.append(InvertibleConv(n_remaining))
            self.WN.append(WaveNetAE(n_half, self.mel_channels * self.n_group, n_channels=wn["n_channels"],
                                     n_layers=wn["n_layers"], kernel_size=wn["kernel_size"], n_out_channels=2 * n_half,
                                     cond_kernel_size=1, cond_conv_upsampling=None,
                                     compute_dtype=self.wn_compute_dtype, name=f"WN{k}"))
        self.n_remaining_channels = n_remaining
        self.flow_spans = [f"{MODEL_WAVENET}flow{k}" for k in range(self.n_flows)]  # each WN's span name

    def early_flows(self) -> List[int]:
        """The flows after which an early z is prepended, in synthesis order."""
        return [k for k in reversed(range(self.n_flows)) if k % self.n_early_every == 0 and k > 0]

    def noise_shape(self, batch: int, T_mel: int):
        """The shape of `infer`'s `noise` for a mel of T_mel frames."""
        return batch, T_mel * self.spect_hop_size // self.n_group, self.n_group

    def _noise(self, B: int, T_g: int, device, noise: Optional[torch.Tensor]) -> List[torch.Tensor]:
        """[initial z, early z...] (B, T_g, channels) fp32: slices of `noise`,
        or drawn as glow.py draws them (B, channels, T_g), in that order, from
        a generator seeded 0 on the device."""
        sizes = [self.n_remaining_channels] + [self.n_early_size] * len(self.early_flows())
        if noise is not None:
            if tuple(noise.shape) != (B, T_g, sum(sizes)):
                raise ValueError(f"WaveGlow: noise of shape {tuple(noise.shape)}, expected {(B, T_g, sum(sizes))}")
            return list(noise.to(device, torch.float32).split(sizes, dim=-1))
        gen = torch.Generator(device=device).manual_seed(0)
        return [torch.randn((B, n, T_g), generator=gen, device=device).transpose(1, 2) for n in sizes]

    @exact_fp32()
    def infer(self, spect: torch.Tensor, synth_length: int = 0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, n_mel) log-mel -> (B, synth_length) audio (T * hop samples
        by default); a mel shorter than synth_length is extended by its last
        frame, as the registry models extend it."""
        synth_length = synth_length if synth_length else spect.shape[1] * self.spect_hop_size
        short = -(-synth_length // self.spect_hop_size) - spect.shape[1]
        if short > 0:
            spect = torch.cat((spect, spect[:, -1:].expand(-1, short, -1)), dim=1)
        with span(WAVEGLOW_UPSAMPLE):
            cond = self.upsample(spect.float())
            if self.wn_compute_dtype is not None:
                cond = cond.to(self.wn_compute_dtype)  # the fp32 copy is not held through the flows
        B, T_g, _ = cond.shape
        with span(WAVEGLOW_COUPLING):
            z = self._noise(B, T_g, cond.device, noise)
            audio = self.sigma * z[0]
        early = iter(z[1:])
        for k in reversed(range(self.n_flows)):
            n_half = audio.shape[-1] // 2
            with span(self.flow_spans[k]):
                out = self.WN[k](audio[..., :n_half], cond)
            with span(WAVEGLOW_COUPLING):
                b, s = out[..., :n_half], out[..., n_half:]
                audio = torch.cat([audio[..., :n_half], (audio[..., n_half:] - b) / torch.exp(s)], dim=-1)
                audio = audio @ self.convinv[k].inverse().t()
                if k % self.n_early_every == 0 and k > 0:
                    audio = torch.cat([self.sigma * next(early), audio], dim=-1)
        return audio.reshape(B, -1)[:, :synth_length]
