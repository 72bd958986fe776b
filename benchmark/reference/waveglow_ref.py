"""Plain PyTorch reference of WaveGlow synthesis, for the benchmark's check,
and the writer of its seeded weights.

WaveGlow: Prenger, Valle & Catanzaro, "WaveGlow: A Flow-based Generative
Network for Speech Synthesis", ICASSP 2019, arXiv:1811.00002; NVIDIA's
github.com/NVIDIA/waveglow `glow.py` (`WaveGlow.infer`, `WaveGlow.forward`,
`WN`, `Invertible1x1Conv`).  It reads a model directory's `weights.npz`
itself, folds the weight norm itself, and imports nothing of the program
under test.  Its arithmetic is glow.py's, in glow.py's channels-first
layout (B, C, T), with these departures:
- the mel comes in as (B, T, n_mel) log-mel, the program's convention;
- the noise is drawn as the program draws it, from a generator seeded 0 on
  the device (first the initial z, then each early z, each
  (B, channels, T/n_group) as glow.py shapes them), or handed in;
- W_k^-1 is inverted in fp64 (glow.py: fp32) and used in the reference's
  dtype;
- the WN's `end` conv is not glow.py's zeros (which make every coupling the
  identity and hide the WN from the check): `draw_weights` draws it at a
  small scale (`end_scale`);
- `forward` (glow.py's training direction) is kept only to check that
  `synth` inverts it.

Precision ("mode"): "fp32" (TF32 off), "fp64" for the inverse check, and
"fp8", the control one precision below what the configuration states: every
WN conv's operands rounded to float8 e4m3 (a per-tensor scale for
activations, a per-output-channel scale for weights) before an fp32 product,
and the upsampler (fp32 in the configuration) in bf16.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from reference.mbexwn_ref import fake_fp8

_MODES = {"fp32": torch.float32, "fp64": torch.float64, "fp8": torch.float32}
UPSAMPLE_KERNEL = 1024  # glow.py's ConvTranspose1d(n_mel, n_mel, 1024, stride=256)


# ----------------------------------------------------------------- weights

def _shapes(wg: Dict, n_mel: int):
    """(npz path, shape, how it is drawn) of every tensor, in a fixed order:
    "kaiming" U(+-1/sqrt(fan_in)) as PyTorch's Conv1d and ConvTranspose1d
    initialise kernel and bias; "end" N(0, end_scale^2); "qr" glow.py's
    `Invertible1x1Conv` init."""
    wn = wg["WN_config"]
    C, L, K, G = wn["n_channels"], wn["n_layers"], wn["kernel_size"], wg["n_group"]
    k_up = UPSAMPLE_KERNEL
    out = [("upsample/kernel", (k_up, n_mel, n_mel), "kaiming", n_mel * k_up),
           ("upsample/b", (n_mel,), "kaiming", n_mel * k_up)]
    n_half, n_rem = G // 2, G
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            n_half -= wg["n_early_size"] // 2
            n_rem -= wg["n_early_size"]
        p = f"WN/{k}"
        convs = [("start", 1, n_half, C), ("cond", 1, n_mel * G, 2 * C * L)]
        for i in range(L):
            convs += [(f"conv1D_{i}", K, C, 2 * C), (f"res_skip_{i}", 1, C, 2 * C if i < L - 1 else C)]
        for name, width, cin, cout in convs:
            out += [(f"{p}/{name}/v", (width, cin, cout), "kaiming", width * cin), (f"{p}/{name}/g", (cout,), "norm", 0),
                    (f"{p}/{name}/b", (cout,), "kaiming", width * cin)]
        out += [(f"{p}/end/kernel", (1, C, 2 * n_half), "end", 0), (f"{p}/end/b", (2 * n_half,), "end", 0),
                (f"convinv/{k}/kernel", (1, n_rem, n_rem), "qr", 0)]
    return out


def draw_weights(config: Dict) -> Dict[str, np.ndarray]:
    """Every tensor of the model at its published shape, fp32, each from its
    own stream of `config["weights_seed"]` (a weight-normalised conv's g is
    the norm of its v, as `torch.nn.utils.weight_norm` starts)."""
    wg, n_mel = config["waveglow_config"], config["preprocess_config"]["mel_channels"]
    seed, end_scale = int(config["weights_seed"]), float(config["end_scale"])
    flat = {}
    for index, (path, shape, how, fan_in) in enumerate(_shapes(wg, n_mel)):
        rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
        if how == "kaiming":
            bound = 1.0 / np.sqrt(fan_in)
            flat[path] = rng.uniform(-bound, bound, shape).astype(np.float32)
        elif how == "end":
            flat[path] = (end_scale * rng.standard_normal(shape)).astype(np.float32)
        elif how == "qr":
            w = np.linalg.qr(rng.standard_normal(shape[1:]))[0]
            if np.linalg.det(w) < 0:
                w[:, 0] = -w[:, 0]
            flat[path] = np.ascontiguousarray(w.T[None]).astype(np.float32)  # WIO: kernel[0, i, o] = W[o, i]
        else:
            v = flat[path[:-1] + "v"].astype(np.float64)
            flat[path] = np.sqrt((v * v).sum(axis=(0, 1))).astype(np.float32)
    return flat


def write_model_dir(config: Dict, path) -> Path:
    """A model directory (`config.yaml` + `weights.npz`) of the configuration
    with its seeded weights, written under a temporary name and renamed into
    place, so a reader sees all of it or none."""
    path = Path(path)
    tmp = Path(tempfile.mkdtemp(prefix=path.name + ".", dir=path.parent))
    hparams = {"preprocess_config": config["preprocess_config"], "training_config": {},
               "waveglow_config": config["waveglow_config"]}
    (tmp / "config.yaml").write_text(yaml.safe_dump(hparams))
    np.savez(tmp / "weights.npz", **draw_weights(config))
    try:
        os.replace(tmp, path)
    except OSError:  # another process put it there first
        for f in tmp.iterdir():
            f.unlink()
        tmp.rmdir()
    return path


def model_dir(config: Dict) -> Path:
    """The configuration's model directory in the system's temporary
    directory, keyed by a hash of the configuration; written when absent."""
    key = hashlib.sha256(json.dumps(config, sort_keys=True).encode()).hexdigest()[:16]
    path = Path(tempfile.gettempdir()) / f"mbexwn_waveglow_{key}"
    if not (path / "weights.npz").is_file():
        write_model_dir(config, path)
    return path


def fold_weights(npz_path, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{module path: tensor}: each weight-normalised conv folded to its OIW
    kernel `path/w` (g * v / ||v||, the norm over width and input per output
    channel, eps 1e-12, in fp64); a plain kernel (WIO) to OIW `path/w`;
    biases `path/b`."""
    with np.load(npz_path, allow_pickle=False) as z:
        raw = {k: z[k] for k in z.files}
    out = {}
    for key, val in raw.items():
        mod, leaf = key.rsplit("/", 1)
        if leaf == "v":
            v = torch.from_numpy(val.astype(np.float64)).permute(2, 1, 0)
            g = torch.from_numpy(raw[mod + "/g"].astype(np.float64))
            norm = torch.sqrt(torch.clamp((v * v).sum(dim=(1, 2), keepdim=True), min=1e-12))
            out[mod + "/w"] = (g[:, None, None] * v / norm).to(dtype).contiguous()
        elif leaf == "kernel":
            out[mod + "/w"] = torch.from_numpy(val.astype(np.float64)).permute(2, 1, 0).to(dtype).contiguous()
        elif leaf == "b":
            out[key] = torch.from_numpy(val).to(dtype)
    return out


# ------------------------------------------------------------------- model

@contextlib.contextmanager
def _no_tf32():
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """WaveGlow synthesis of the model in the directory `model_path` (as
    `model_dir` writes it) of the configuration `config` (a benchmark
    configuration's dict), on `device`, in `mode`."""

    def __init__(self, config: Dict, model_path, device="cpu", mode: str = "fp32"):
        if mode not in _MODES:
            raise ValueError(f"mode {mode}")
        self.mode, self.dtype, self.device = mode, _MODES[mode], torch.device(device)
        wg = config["waveglow_config"]
        self.hop, self.n_mel = config["preprocess_config"]["hop_size"], config["preprocess_config"]["mel_channels"]
        self.n_flows, self.G = wg["n_flows"], wg["n_group"]
        self.n_early_every, self.n_early_size = wg["n_early_every"], wg["n_early_size"]
        self.sigma = float(wg.get("sigma", 1.0))
        self.C, self.L = wg["WN_config"]["n_channels"], wg["WN_config"]["n_layers"]
        self.k_up = UPSAMPLE_KERNEL
        self.n_rem = self.G - self.n_early_size * len(self.early_flows())
        self.w = {k: v.to(self.device) for k, v in fold_weights(Path(model_path) / "weights.npz", self.dtype).items()}
        self.w_inv = {}
        for k in range(self.n_flows):
            W = self.w[f"convinv/{k}/w"][:, :, 0].double()
            self.w_inv[k] = torch.linalg.inv(W).to(self.dtype)[:, :, None]

    def early_flows(self) -> List[int]:
        return [k for k in reversed(range(self.n_flows)) if k % self.n_early_every == 0 and k > 0]

    def _conv(self, x, name, dilation: int = 1, padding: int = 0):
        w, b = self.w[f"{name}/w"], self.w[f"{name}/b"]
        if self.mode == "fp8":
            return F.conv1d(fake_fp8(x), fake_fp8(w, dim=0), b.float(), dilation=dilation, padding=padding)
        return F.conv1d(x, w, b, dilation=dilation, padding=padding)

    @_no_tf32()
    def upsampled(self, mell: torch.Tensor) -> torch.Tensor:
        """glow.py's upsample, trim and unfold: (B, T, n_mel) -> (B, n_mel * G, T * hop / G)."""
        w = self.w["upsample/w"].transpose(0, 1)  # (in, out, k), ConvTranspose1d's layout
        x, b = mell.to(self.device, self.dtype).transpose(1, 2), self.w["upsample/b"]
        if self.mode == "fp8":
            x, w, b = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        spect = F.conv_transpose1d(x, w, b, stride=self.hop).to(self.dtype)
        spect = spect[:, :, : spect.shape[2] - (self.k_up - self.hop)]
        spect = spect.unfold(2, self.G, self.G).permute(0, 2, 1, 3)
        return spect.contiguous().view(spect.size(0), spect.size(1), -1).permute(0, 2, 1)

    def wn(self, k: int, audio: torch.Tensor, spect: torch.Tensor) -> torch.Tensor:
        """glow.py's `WN.forward` of flow k: (B, n_half, T) audio, (B, n_mel * G, T) spect."""
        p, C = f"WN/{k}", self.C
        audio = self._conv(audio, f"{p}/start")
        spect = self._conv(spect, f"{p}/cond")
        output = torch.zeros_like(audio)
        for i in range(self.L):
            d = 2 ** i
            acts = self._conv(audio, f"{p}/conv1D_{i}", d, d) + spect[:, i * 2 * C:(i + 1) * 2 * C]
            acts = torch.tanh(acts[:, :C]) * torch.sigmoid(acts[:, C:])
            res_skip = self._conv(acts, f"{p}/res_skip_{i}")
            if i < self.L - 1:
                audio = audio + res_skip[:, :C]
                output = output + res_skip[:, C:]
            else:
                output = output + res_skip
        return self._conv(output, f"{p}/end")

    def noise(self, B: int, T_g: int) -> List[torch.Tensor]:
        """[initial z, early z...] as the program draws them."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        sizes = [self.n_rem] + [self.n_early_size] * len(self.early_flows())
        return [torch.randn((B, n, T_g), generator=gen, device=self.device) for n in sizes]

    @torch.no_grad()
    @_no_tf32()
    def synth(self, mell: torch.Tensor, synth_length: int = 0, z: Optional[List[torch.Tensor]] = None,
              sigma: Optional[float] = None) -> torch.Tensor:
        """(B, T, n_mel) log-mel -> (B, synth_length) audio: glow.py's `infer`.
        `z`: [initial z, early z...] (B, channels, T * hop / G), standard
        normal, scaled by `sigma` (the configuration's by default)."""
        sigma = self.sigma if sigma is None else sigma
        B, T = mell.shape[:2]
        synth_length = synth_length or T * self.hop
        short = -(-synth_length // self.hop) - T
        if short > 0:
            mell = torch.cat((mell, mell[:, -1:].expand(-1, short, -1)), dim=1)
        spect = self.upsampled(mell)
        z = self.noise(B, spect.shape[2]) if z is None else [t.to(self.device, self.dtype) for t in z]
        audio = sigma * z[0].to(self.dtype)
        early = iter(z[1:])
        for k in reversed(range(self.n_flows)):
            n_half = audio.size(1) // 2
            output = self.wn(k, audio[:, :n_half], spect)
            s, b = output[:, n_half:], output[:, :n_half]
            audio = torch.cat([audio[:, :n_half], (audio[:, n_half:] - b) / torch.exp(s)], 1)
            audio = F.conv1d(audio, self.w_inv[k])
            if k % self.n_early_every == 0 and k > 0:
                audio = torch.cat((sigma * next(early).to(self.dtype), audio), 1)
        return audio.permute(0, 2, 1).reshape(B, -1)[:, :synth_length]

    @torch.no_grad()
    @_no_tf32()
    def forward(self, mell: torch.Tensor, audio: torch.Tensor):
        """glow.py's `forward` (the training direction): (B, T, n_mel) log-mel,
        (B, T * hop) audio -> (z (B, G, T * hop / G): the early outputs, then
        the last flow's channels; log_s per flow; log det W per flow)."""
        spect = self.upsampled(mell)[:, :, : audio.shape[1] // self.G]
        audio = audio.to(self.device, self.dtype).unfold(1, self.G, self.G).permute(0, 2, 1)
        output_audio, log_s_list, log_det_w = [], [], []
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                output_audio.append(audio[:, :self.n_early_size, :])
                audio = audio[:, self.n_early_size:, :]
            W = self.w[f"convinv/{k}/w"]
            log_det_w.append(audio.shape[0] * audio.shape[2] * torch.logdet(W[:, :, 0]))
            audio = F.conv1d(audio, W)
            n_half = audio.size(1) // 2
            output = self.wn(k, audio[:, :n_half], spect)
            log_s, b = output[:, n_half:], output[:, :n_half]
            audio = torch.cat([audio[:, :n_half], torch.exp(log_s) * audio[:, n_half:] + b], 1)
            log_s_list.append(log_s)
        output_audio.append(audio)
        return torch.cat(output_audio, 1), log_s_list, log_det_w

    def z_for_synth(self, z: torch.Tensor) -> List[torch.Tensor]:
        """`forward`'s z (early outputs in flow order, then the last flow's
        channels) as `synth` takes it: [initial z, early z in synthesis order]."""
        n_early = len(self.early_flows())
        early = [z[:, i * self.n_early_size:(i + 1) * self.n_early_size] for i in range(n_early)]
        return [z[:, n_early * self.n_early_size:]] + early[::-1]
