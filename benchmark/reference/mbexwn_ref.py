"""Plain PyTorch reference of MBExWN synthesis, for the benchmark's check.

It reads a configuration file of `benchmark/configs/` and the registry's
`weights.npz` itself, and imports nothing of the program under test.  It
implements the registry models' path only: NormMel (per-frame RMS from the
mel-band energies), the F0 net, the wavetable oscillator (fp64 phase), the
reshape fold with the noise channel, the WaveNet blocks (gated, dilated,
shared upsampled conditioning), the post net, PQMF synthesis, the cepstral
envelope (F0-adaptive cepstral windows, tanh range limit) applied by
STFT/iSTFT, the RMS gain, and the causal padding of live synthesis.

Precision ("modes"):
- the subnets (F0 net, envelope net) run in the precision the configuration
  states (`subnet_compute_dtype`, bf16 for the registry models): their
  small rounding differences reach the oscillator's phase integral, which
  turns them into an audible drift of the whole waveform, so the check
  holds the F0 stage on its own (`f0`) and the synthesis from a given F0;
- the WaveNet blocks, the post net, the oscillator, PQMF and the envelope
  run in fp32 with TF32 off, above the bf16 the configuration states for
  the WaveNet, so the kernel under test is held against exact arithmetic;
- "fp8" (either part) rounds every conv's operands to float8 e4m3 (a
  per-tensor scale for activations, a per-output-channel scale for weights)
  before an fp32 product: the control, one precision below bf16.

The noise channel is drawn as the program draws it, from a generator
seeded 0 on the device (`noise=None`), or handed in.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-7
_F8 = torch.float8_e4m3fn
_F8_MAX = 448.0
_MODES = ("fp32", "bf16", "fp8")
_DTYPES = {"bfloat16": "bf16", "float32": "fp32", "": "fp32", None: "fp32"}


# ----------------------------------------------------------------- weights

def fold_weights(npz_path) -> Dict[str, torch.Tensor]:
    """{module path: tensor}: each weight-normalised conv folded to its OIW
    kernel `path/w` (g * v / ||v||, the norm over width and input per output
    channel, eps 1e-12) with its bias `path/b`; PReLU alphas and the
    wavetables as they are.  fp16 distribution copies are read as fp32."""
    with np.load(npz_path, allow_pickle=False) as z:
        raw = {k: z[k] for k in z.files if not k.startswith("__")}
    out = {}
    for key, val in raw.items():
        mod, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
        val = np.asarray(val, np.float32)
        if leaf == "v":
            v = torch.from_numpy(val).permute(2, 1, 0)  # WIO -> OIW
            g = torch.from_numpy(np.asarray(raw[mod + "/g"], np.float32))
            norm = torch.sqrt(torch.clamp((v * v).sum(dim=(1, 2), keepdim=True), min=1e-12))
            out[mod + "/w"] = (g[:, None, None] * (v / norm)).contiguous()
        elif leaf == "b":
            out[mod + "/b"] = torch.from_numpy(val)
        elif leaf != "g":
            out[key] = torch.from_numpy(val)
    return out


def weights_path(config: Dict, repo_root) -> Path:
    return Path(repo_root) / "mbexwn_vocoder_tpu" / "models_registry" / config["registry_dir"] / "weights.npz"


# ------------------------------------------------------------- primitives

def fake_fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its abs-max (over all
    of x, or per index of `dim`) to the format's largest value; fp32 out."""
    x = x.float()
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=[d for d in range(x.dim()) if d != dim], keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / _F8_MAX
    return (x / scale).to(_F8).float() * scale


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], pads=(0, 0), dilation: int = 1,
         mode: str = "fp32") -> torch.Tensor:
    """(B, T, Cin) x, OIW kernel -> (B, T', Cout).  fp32 and bf16 compute in
    that dtype (the result too); fp8 rounds x and the kernel to e4m3, then
    computes in fp32 and returns bf16."""
    if mode == "fp8":
        xt = fake_fp8(x).transpose(1, 2)
        wq, bq, out_dtype = fake_fp8(w, dim=0), None if b is None else b.float(), torch.bfloat16
    else:
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        xt, wq, bq, out_dtype = x.to(dt).transpose(1, 2), w.to(dt), None if b is None else b.to(dt), dt
    if pads[0] or pads[1]:
        xt = F.pad(xt, pads)
    return F.conv1d(xt, wq.to(xt.dtype), None if bq is None else bq.to(xt.dtype), dilation=dilation
                    ).transpose(1, 2).to(out_dtype)


def conv_pads(k: int, dilation: int, causal: bool):
    span = (k - 1) * dilation
    return (span, 0) if causal else (span // 2, span - span // 2)


def lin_up(x: torch.Tensor, factor: int, pad_end: int, drop_last: bool) -> torch.Tensor:
    """Linear interpolation by `factor` along time of (B, T, C): `pad_end`
    copies of the last frame, then out[t*U + j] = lerp(x[t], x[t+1], j/U)."""
    if pad_end:
        x = torch.cat([x, x[:, -1:].expand(-1, pad_end, -1)], dim=1)
    if factor == 1:
        return x
    B, T, C = x.shape
    w1 = (torch.arange(factor, dtype=x.dtype, device=x.device) / factor)[None, None, :, None]
    y = (x[:, :-1, None, :] * (1.0 - w1) + x[:, 1:, None, :] * w1).reshape(B, (T - 1) * factor, C)
    return y if drop_last else torch.cat([y, x[:, -1:]], dim=1)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0.0) + alpha.to(x.dtype) * torch.clamp(x, max=0.0)


def symmetric_pad(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    T = x.shape[1]
    return torch.cat([x[:, :lo].flip(1), x, x[:, T - hi:].flip(1)], dim=1)


def hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def slaney_mel_frequencies(n: int, fmin: float, fmax: float) -> np.ndarray:
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        return f / f_sp if f < min_log_hz else min_log_mel + np.log(f / min_log_hz) / logstep

    mels = np.linspace(to_mel(fmin), to_mel(fmax), n)
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


def pqmf_synthesis_bank(subbands: int, taps: int, cutoff: float, beta: float) -> np.ndarray:
    """(subbands, taps + 1) cosine-modulated synthesis filters of a
    Kaiser-windowed sinc prototype."""
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore", divide="ignore"):
        proto = np.sin(np.pi * cutoff * n) / (np.pi * n)
    proto[taps // 2] = cutoff
    proto = proto * np.kaiser(taps + 1, beta)
    k = np.arange(subbands)[:, None]
    return (2 * proto * np.cos((2 * k + 1) * (np.pi / (2 * subbands)) * n - (-1.0) ** k * np.pi / 4)
            ).astype(np.float32)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, F, L) -> (B, (F - 1) * hop + L), L a multiple of hop."""
    B, n, L = frames.shape
    m = L // hop
    out = frames.new_zeros((B, n - 1 + m, hop))
    blocks = frames.reshape(B, n, m, hop)
    for j in range(m):
        out[:, j: j + n] += blocks[:, :, j]
    return out.reshape(B, -1)


# ------------------------------------------------------------------- model

class Reference:
    """MBExWN synthesis of one configuration (a `benchmark/configs/` file's
    dict), its weights folded from `weights.npz`, on `device`."""

    def __init__(self, config: Dict, npz_path, device="cpu", causal: bool = False,
                 subnet_mode: Optional[str] = None, wn_mode: str = "fp32"):
        pre, mb = config["preprocess_config"], config["mbexwn_config"]
        self.device = torch.device(device)
        self.causal = causal or bool(mb.get("force_causal", False))
        self.subnet_mode = subnet_mode or _DTYPES[mb.get("subnet_compute_dtype")]
        self.wn_mode = wn_mode
        if self.subnet_mode not in _MODES or wn_mode not in _MODES:
            raise ValueError(f"modes: {self.subnet_mode}, {wn_mode}")
        self.w = {k: v.to(self.device) for k, v in fold_weights(npz_path).items()}
        self.sr, self.hop, self.n_mels = pre["sample_rate"], pre["hop_size"], pre["mel_channels"]
        self.win = pre.get("win_size", pre["fft_size"])
        self.mb = mb
        self.subbands = mb["multi_band_config"]["subbands"]
        self.pulse_channels = mb["pulse_channels"]
        self.pulse_rate = self.sr / mb["pulse_rate_factor"]
        ups = mb["pp_mod_subnet_upsampling_factors"]
        self.stp = (self.hop // self.subbands) * self.pulse_channels // int(np.prod(ups))  # mel frame -> pulse rate
        self.f0_down = int(self.sr // self.pulse_rate)
        self.sigma = mb["pp_mod_subnet_noise_channel_sigma"]
        wn = mb["pp_mod_subnet"]
        self.C, self.n_layers = wn["n_channels"], wn["n_layers"]
        self.dilations = [2 ** (i // wn["dilation_rate_step"] % wn["max_log2_dilation_rate"])
                          for i in range(self.n_layers)]
        self.cond_lin = wn["cond_lin_upsampling"]
        self.blocks = []
        rate, spect_rate = self.pulse_rate / self.pulse_channels, self.sr / self.hop
        for i, up in enumerate(ups):
            self.blocks.append((f"PP_waveNetBlock_ups{up}_{i}", up, int(rate // (spect_rate * self.cond_lin))))
            rate *= up
        # NormMel's band widths
        mel_f = slaney_mel_frequencies(self.n_mels + 2, pre["fmin"], pre["fmax"])
        self.inv_enorm = torch.tensor((mel_f[2:] - mel_f[:-2]) / 2.0, dtype=torch.float32, device=self.device)
        self.rms_norm = pre["fft_size"] * self.win * 0.5
        self.lin_amp_off = pre.get("lin_amp_off", 1e-5)
        # oscillator grid: the realisable nominal F0 of a pulse period of the next power of two samples
        wt = mb["wavetable_config"]
        period = 1 << math.ceil(math.log2(math.ceil(wt["wt_oversampling"] * self.pulse_rate / wt["nominalF0"])))
        self.nominal_f0 = wt["wt_oversampling"] * self.pulse_rate / period
        n_grid = int(np.ceil(np.log(wt["maxF0"] / self.nominal_f0) / np.log(wt["F0GridFactor"])))
        self.grid_factor = wt["F0GridFactor"]
        self.max_tr = self.grid_factor ** n_grid
        self.tables = self.w["wavetables"]
        if self.tables.shape != (period + 1, n_grid + 1):
            raise ValueError(f"wavetables {tuple(self.tables.shape)} != {(period + 1, n_grid + 1)}")
        # PQMF synthesis bank, envelope and STFT constants
        m = mb["multi_band_config"]
        self.taps = m["taps"]
        self.pqmf = torch.from_numpy(pqmf_synthesis_bank(self.subbands, m["taps"], m["cutoff_ratio"], m["beta"])
                                     )[None].to(self.device)
        self.stft_win = 4 * self.hop
        self.fft = 1 << math.ceil(math.log2(max(self.stft_win, 16)))
        window = hann_periodic(self.stft_win)
        sq = (window.astype(np.float64) ** 2).reshape(-1, self.hop).sum(axis=0)
        self.stft_window = torch.from_numpy(window).to(self.device)
        self.istft_window = torch.from_numpy((window / np.tile(sq, self.stft_win // self.hop)).astype(np.float32)
                                             ).to(self.device)
        smooth = np.bartlett(2 * self.hop + 3)[1:-1]
        self.smooth = torch.from_numpy((smooth / smooth.sum()).astype(np.float32)).to(self.device)
        self.n_ceps = mb["ps_max_ceps_coefs"]
        log10f0, windows = [], []
        for f0 in np.logspace(np.log10(mb["pp_min_frequency"]), np.log10(mb["pp_max_frequency"]), 30):
            n = int(mb["ps_env_order_scale"] * 0.5 * self.sr / f0)
            n += 1 - n % 2
            half = np.hamming(n)[n // 2:]
            windows.append(half[: self.n_ceps] if n // 2 + 1 > self.n_ceps
                           else np.concatenate((half, np.zeros(self.n_ceps - 1 - n // 2))))
            log10f0.append(np.log10(f0))
        self.ceps_log10f0 = torch.tensor(np.asarray(log10f0, np.float32), device=self.device)
        self.ceps_windows = torch.tensor(np.asarray(windows, np.float32), device=self.device)
        self.max_log_range = mb["filter_max_db_range"] / (20.0 * np.log10(np.e))

    # -------------------------------------------------------------- pieces

    def normalize(self, mell: torch.Tensor, synth_length: int):
        """(B, T, C) log-mel -> (normalised log-mel, the RMS gain (B, synth_length))."""
        mel = torch.exp(mell)
        rms = torch.sqrt(torch.sum((mel * self.inv_enorm) ** 2, dim=-1) / self.rms_norm)[:, :, None]
        norm = torch.log(mel / torch.clamp(rms, min=_EPS) + self.lin_amp_off)
        gain = lin_up(rms, self.hop, 0, False)[:, :, 0]
        if gain.shape[1] < synth_length:
            gain = torch.cat([gain, gain[:, -1:].expand(-1, synth_length - gain.shape[1])], dim=1)
        return norm, gain[:, :synth_length]

    def _subnet(self, prefix: str, name: str, specs, mel: torch.Tensor, target_ups=None, soft_sigmoid=False,
                mode=None) -> torch.Tensor:
        """A conditioning subnet in `mode`: per spec a conv (with its
        symmetric pad, sub-pixel or linear upsampling) and a PReLU, then the
        final 1x1 conv, the missing linear upsampling and the final
        activation, all in the compute dtype."""
        mode = mode or self.subnet_mode
        x = mel
        total_ups = 1
        k = self.w
        for i, spec in enumerate(specs):
            ks, nf = spec[0], spec[1]
            up, linear = 1, False
            if len(spec) > 2:
                linear = isinstance(spec[2], str)
                up = int(spec[2][1:]) if linear else int(spec[2])
            wk, bk = k[f"{prefix}/{name}_Layer_{i}/w"], k[f"{prefix}/{name}_Layer_{i}/b"]
            if up > 1 and not linear:
                y = conv(x, wk, bk, conv_pads(ks, 1, self.causal), mode=mode)
                B, T, Cu = y.shape
                y = y.reshape(B, T * up, Cu // up)
            else:
                lo, hi = (ks - 1) // 2 + (ks - 1) % 2, (ks - 1) // 2
                y = conv(symmetric_pad(x, lo + hi, 0) if self.causal else symmetric_pad(x, lo, hi), wk, bk, mode=mode)
                if linear:
                    y = lin_up(y, up, 1, True)
            x = prelu(y, k[f"{prefix}/{name}_ActLayer_{i}/alpha"])
            total_ups *= up
        x = conv(x, k[f"{prefix}/{name}_Layer_final/w"], k[f"{prefix}/{name}_Layer_final/b"], mode=mode)
        if target_ups is not None and total_ups != target_ups:
            x = lin_up(x, target_ups // total_ups, 1, True)
        return 0.5 + 0.5 * x / (1.0 + torch.abs(x)) if soft_sigmoid else x

    def f0(self, mel_norm: torch.Tensor, mode=None) -> torch.Tensor:
        """(B, T, C) normalised log-mel -> (B, T * stp) F0 in Hz."""
        x = self._subnet("pp_subnet", "PulsPar", self.mb["pp_subnet"], mel_norm, self.stp, True, mode)
        return self.f0_from_net_output(x, mel_norm.shape[1])

    def f0_from_net_output(self, x: torch.Tensor, T: int) -> torch.Tensor:
        """The F0 contour (B, T*stp) from the F0 net's output (B, >= T*stp, 1),
        the soft sigmoid's, in the net's dtype."""
        mb = self.mb
        x = x.float()
        return (x[:, :, 0] * (mb["pp_max_frequency"] - mb["pp_min_frequency"]) + mb["pp_min_frequency"])[:, : T * self.stp]

    def oscillate(self, f0: torch.Tensor, phase_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        """F0 (B, T) at the pulse rate -> the cross-faded wavetable pulse (B, T);
        the phase is an fp64 prefix sum of the fp32 increments F0 * (1/rate)."""
        inc = f0.float() * torch.tensor(1.0 / self.pulse_rate, dtype=torch.float32)
        phase = torch.cumsum(inc.double(), dim=1)
        if phase_offset is not None:
            phase = phase + phase_offset.double()[:, None]
        phase = torch.remainder(phase, 1.0).float()
        n_period = self.tables.shape[0] - 1
        pw = phase * n_period
        j0 = torch.clamp(torch.floor(pw), 0, n_period - 1)
        frac = (pw - j0)[..., None]
        j0 = j0.long()
        grid = self.tables[j0] * (1.0 - frac) + self.tables[j0 + 1] * frac
        ratio = torch.log(torch.clamp(f0.float() / self.nominal_f0, 1.0, self.max_tr))[..., None]
        diff = ratio / math.log(self.grid_factor) - torch.arange(grid.shape[-1], device=f0.device)
        return torch.sum(grid * torch.clamp(1.0 - torch.abs(diff), min=0.0), dim=-1)

    def noise(self, B: int, L: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(0)
        return torch.randn((B, L, 1), generator=gen, dtype=torch.float32, device=self.device)

    def wavenet_block(self, name: str, up: int, cond_up: int, x: torch.Tensor, mel_norm: torch.Tensor) -> torch.Tensor:
        k, m, C = self.w, self.wn_mode, self.C
        p = f"{name}/wavenet"
        x = conv(x, k[f"{p}/start/w"], k[f"{p}/start/b"], mode=m).float()
        cond = conv(mel_norm, k[f"{p}/cond/w"], k[f"{p}/cond/b"], conv_pads(3, 1, self.causal), mode=m).float()
        B, T, Cc = cond.shape
        cond = lin_up(cond.reshape(B, T * cond_up, Cc // cond_up), self.cond_lin, 1, True)
        skip = None
        for i, d in enumerate(self.dilations):
            y = conv(x, k[f"{p}/conv1D_{i}/w"], k[f"{p}/conv1D_{i}/b"], conv_pads(3, d, self.causal), d,
                     mode=m).float() + cond
            g = torch.tanh(y[..., :C]) * torch.sigmoid(y[..., C:])
            rs = conv(g, k[f"{p}/res_skip_{i}/w"], k[f"{p}/res_skip_{i}/b"], mode=m).float()
            if i < self.n_layers - 1:
                x = x + rs[..., :C]
                rs = rs[..., C:]
            skip = rs if skip is None else skip + rs
        y = conv(skip, k[f"{p}/end/w"], k[f"{p}/end/b"], mode=m).float()
        if up > 1:
            y = conv(y, k[f"{name}/up_down/w"], k[f"{name}/up_down/b"], conv_pads(3, 1, self.causal)).float()
            B, T, Cu = y.shape
            y = y.reshape(B, T * up, Cu // up)
        return y

    def envelope(self, mel_norm: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        """The complex cepstral envelope filter (B, T, fft/2 + 1)."""
        ceps = self._subnet("ps_subnet", "PS", self.mb["ps_subnet"], mel_norm).float()
        kw = self.smooth.shape[0]
        padded = torch.cat([f0[:, :1].expand(-1, kw // 2), f0, f0[:, -1:].expand(-1, kw // 2)], dim=1)
        smoothed = F.conv1d(padded[:, None, :], self.smooth[None, None, :], stride=self.stp)[:, 0]
        lg = self.ceps_log10f0
        s = torch.clamp((1 / np.log(10)) * torch.log(smoothed), lg[0], lg[-1])
        idx = torch.round((s - lg[0]) / (lg[-1] - lg[0]) * (lg.shape[0] - 1)).long()
        ceps = F.pad((ceps * self.ceps_windows[idx])[:, :, 1:], (1, 0))
        spec = torch.fft.rfft(ceps, n=self.fft, dim=-1)
        return torch.exp(torch.complex(self.max_log_range * torch.tanh(spec.real), spec.imag))

    # ----------------------------------------------------------- synthesis

    @torch.no_grad()
    def synth(self, mell: torch.Tensor, synth_length: int, f0: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, phase_offset: Optional[torch.Tensor] = None,
              f0_net_output: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C) log-mel (fp32, on the device) -> (B, synth_length) audio.
        The F0 comes from `f0`, from the F0 net's output `f0_net_output`, or
        from this reference's own F0 net."""
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._synth(mell, synth_length, f0, noise, phase_offset, f0_net_output)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def _synth(self, mell, synth_length, f0, noise, phase_offset, f0_net_output):
        B, T, _ = mell.shape
        if T * self.hop < synth_length:
            mell = torch.cat([mell, mell[:, -1:]], dim=1)
            T += 1
        mel_norm, gain = self.normalize(mell, synth_length)
        if f0 is None:
            f0 = self.f0(mel_norm) if f0_net_output is None else self.f0_from_net_output(f0_net_output, T)
        pulse = self.oscillate(f0, phase_offset)
        x = pulse.reshape(B, -1, self.pulse_channels)
        if self.sigma:
            if noise is None:
                noise = self.noise(B, x.shape[1])
            x = torch.cat([x, self.sigma * noise.to(x.device, x.dtype)], dim=-1)
        for name, up, cond_up in self.blocks:
            x = self.wavenet_block(name, up, cond_up, x, mel_norm)
        x = conv(x, self.w["wn_post_net/w"], self.w["wn_post_net/b"]).float()
        # PQMF synthesis: zero-stuff each band by `subbands` (scaled), filter, sum the bands
        Bx, L, S = x.shape
        up = torch.cat([(x * S)[:, :, None, :], x.new_zeros((Bx, L, S - 1, S))], dim=2).reshape(Bx, L * S, S)
        exc = conv(up, self.pqmf, None, (self.taps // 2, self.taps // 2)).float()[:, :, 0]
        # the envelope filter in the STFT domain
        win, hop = self.stft_win, self.hop
        padded = F.pad(exc, (win // 2, win // 2 + hop + 1))
        frames = padded.unfold(-1, win, hop) * self.stft_window
        stft = torch.fft.rfft(frames, n=self.fft, dim=-1)[:, :T]
        out = torch.fft.irfft(stft * self.envelope(mel_norm, f0), n=self.fft, dim=-1)[..., :win] * self.istft_window
        signal = overlap_add(out, hop)[:, win // 2: win // 2 + T * self.stp * self.f0_down]
        return signal[:, :synth_length] * gain

    def f0_net(self, mell: torch.Tensor, mode=None) -> torch.Tensor:
        """The F0 net alone on a log-mel (normalised first): its output
        (B, T*stp, 1), the soft sigmoid's, in the subnet's dtype."""
        with torch.no_grad():
            mel_norm, _ = self.normalize(mell, mell.shape[1] * self.hop)
            return self._subnet("pp_subnet", "PulsPar", self.mb["pp_subnet"], mel_norm, self.stp, True, mode)

    def f0_of(self, mell: torch.Tensor, mode=None) -> torch.Tensor:
        """The F0 stage alone: log-mel -> F0, as the synthesis computes it."""
        return self.f0_from_net_output(self.f0_net(mell, mode), mell.shape[1])

def edge_pad(mell: np.ndarray, T_pad: int) -> np.ndarray:
    """(B, T, C) -> (B, T_pad, C), repeating the last frame (a length
    bucket's padding, whose audio is trimmed after synthesis)."""
    T = mell.shape[1]
    return mell if T_pad == T else np.concatenate([mell, np.repeat(mell[:, -1:], T_pad - T, axis=1)], axis=1)
