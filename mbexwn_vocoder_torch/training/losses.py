"""Training losses: multi-resolution STFT bank, NPOW, mel reconstruction,
F0 prediction with voiced/unvoiced mask dilation, STFT coherence and the
windowed time-domain envelope loss.

Counterpart of the JAX package's training/losses.py (the TD loss is the
JAX trainer's inline term).  Signals are (B, T) tensors.  The masking
noises are draws the caller hands in (`noises`, see training/trainer.py),
since torch cannot reproduce the JAX PRNG.  The mel basis product runs in
true fp32 (`exact_fp32`), as the JAX package runs it at HIGHEST precision.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.mel import mel_filter
from ..dsp.utils import nextpow2_val
from ..dsp.windows import get_stft_window, window as make_window
from ..ops.precision import exact_fp32
from ..ops.stft_ops import frame, istft, stft
from .schedules import ParamSchedule

# loss_type bitmask; only the bits with live implementations are active, the
# others are accepted and ignored as in the JAX package
SPECT_LOSS_BIT = 1
NPOW_LOSS_BIT = 32

_EPS = 1e-7


def _reflect_pad(signal: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(B, T) reflect-padded (numpy's "reflect": the edge sample not repeated)."""
    return F.pad(signal[:, None], (lo, hi), mode="reflect")[:, 0]


class MultiResStft:
    """Multi-resolution STFT bank.  win/hop sizes are given in seconds;
    fft = nextpow2(win) * 2**fft_over; symmetric Hann windows normalised to
    sum 1; the signal is reflect-padded (wl//2, wl//2 + hop + 1)."""

    def __init__(self, stft_config: Dict, srate: int):
        self.config = copy.deepcopy(stft_config)
        self.srate = srate
        win_len = self.config["win_size"]
        hop_size = self.config["hop_size"]
        if not hasattr(win_len, "__getitem__"):
            win_len = [win_len]
        if not hasattr(hop_size, "__getitem__"):
            hop_size = [hop_size]
        self.win_len = [int(wl * srate) for wl in win_len]
        self.hop_size = [int(hs * srate) for hs in hop_size]
        if len(self.win_len) != len(self.hop_size):
            raise RuntimeError("MultiResStft::error::win_size and hop_size counts must match")
        if "fft_size" in self.config:
            raise RuntimeError("MultiResStft::error::fft_size is not supported, use fft_over")
        fft_over = self.config.get("fft_over", 0)
        if not hasattr(fft_over, "__getitem__"):
            fft_over = [fft_over]
        if len(fft_over) == 1:
            fft_over = fft_over * len(self.win_len)
        self.fft_size = [nextpow2_val(wl) * (2 ** fo) for wl, fo in zip(self.win_len, fft_over)]
        self.windows = []
        for wl in self.win_len:
            ww = make_window("hann", wl).astype(np.float32)
            self.windows.append(torch.from_numpy(ww / np.sum(ww)))
        self.log_2_db = 20 * np.log10(np.exp(1))
        self.lin_amp_off = self.config.get("lin_amp_off", 1e-5)
        if self.lin_amp_off is None:
            self.lin_amp_off = 1e-5
        self.rel_lin_amp_off = self.config.get("rel_lin_amp_off", False)
        self.magnitude_compression = self.config.get("magnitude_compression", None)
        self.use_lin_amp_off_for_mc = self.config.get("use_lin_amp_off_for_mc", False)

    def generate_stft(self, signal: torch.Tensor) -> List[torch.Tensor]:
        """(B, T) -> list of complex (B, frames, bins)."""
        return [stft(_reflect_pad(signal, wl // 2, wl // 2 + hs + 1), wl, hs, fft_size, win.to(signal))
                for wl, hs, fft_size, win in zip(self.win_len, self.hop_size, self.fft_size, self.windows)]

    def scale_spec(self, spec: torch.Tensor) -> torch.Tensor:
        amp = torch.abs(spec)
        if self.magnitude_compression is not None:
            if self.use_lin_amp_off_for_mc:
                if self.rel_lin_amp_off:
                    off = torch.amax(amp, dim=(-2, -1), keepdim=True) * self.lin_amp_off
                    return torch.pow(amp + off, self.magnitude_compression)
                return torch.pow(amp + self.lin_amp_off, self.magnitude_compression)
            return torch.pow(amp, self.magnitude_compression)
        if self.rel_lin_amp_off:
            off = torch.amax(amp, dim=(-2, -1), keepdim=True) * self.lin_amp_off
            return self.log_2_db * torch.log(amp + off)
        return self.log_2_db * torch.log(amp + self.lin_amp_off)

    def scale_spec_man_select(self, spec: torch.Tensor, magnitude_exponent=None) -> torch.Tensor:
        amp = torch.abs(spec) + self.lin_amp_off
        if magnitude_exponent is not None:
            if magnitude_exponent == 1:
                return amp
            if magnitude_exponent == 2:
                return torch.square(amp)
            return torch.pow(amp, magnitude_exponent)
        return self.log_2_db * torch.log(amp)


class MelLoss:
    """Single-STFT mel L1 with a dynamic-range floor."""

    def __init__(self, preprocess_config: Dict, ign_attn_db: float):
        self.win_len = preprocess_config["win_size"]
        self.hop_size = preprocess_config["hop_size"]
        self.fft_size = preprocess_config["fft_size"]
        self.lin_amp_off = preprocess_config.get("lin_amp_off", 1e-5) or 1e-5
        self.lin_amp_scale = preprocess_config.get("lin_amp_scale", 1)
        self.mel_amp_scale = preprocess_config.get("mel_amp_scale", 1)
        self.ign_attn_db = ign_attn_db
        self.window = torch.from_numpy(self.lin_amp_scale * get_stft_window("hann", self.win_len, np.float32))
        mel_basis = mel_filter(sr=preprocess_config["sample_rate"], n_fft=self.fft_size,
                               n_mels=preprocess_config["mel_channels"], fmin=preprocess_config["fmin"],
                               fmax=preprocess_config["fmax"])
        self.mel_basis_T = torch.from_numpy(np.ascontiguousarray(mel_basis.T))
        self.log_db_fac = 20 * np.log10(2) / np.log(2)

    def mel_spectrogram(self, signal: torch.Tensor) -> torch.Tensor:
        padded = _reflect_pad(signal, self.win_len // 2, self.win_len // 2 + self.hop_size + 1)
        spec = torch.abs(stft(padded, self.win_len, self.hop_size, self.fft_size, self.window.to(signal)))
        with exact_fp32():
            mel = spec @ self.mel_basis_T.to(spec)
        return self.mel_amp_scale * torch.log(mel + self.lin_amp_off)

    def __call__(self, ref_audio: torch.Tensor, gen_audio: torch.Tensor) -> torch.Tensor:
        mel_in = self.mel_spectrogram(ref_audio)
        mel_syn = self.mel_spectrogram(gen_audio)
        if self.ign_attn_db > 0:
            spect_min = torch.amax(mel_in, dim=(1, 2), keepdim=True) - self.ign_attn_db / self.log_db_fac
        else:
            spect_min = torch.tensor(-100.0, device=mel_in.device)
        return self.log_db_fac * torch.mean(torch.abs(
            torch.maximum(mel_syn[:, : mel_in.shape[1]], spect_min) - torch.maximum(mel_in, spect_min)))


def low_band_extra_weight_vector(extra_weight, transition, position, length):
    """Frequency-dependent weighting ramp."""
    k = np.arange(length, dtype=np.float32)
    ramp = np.clip((position + transition - k) / max(transition, 1.0), 0.0, 1.0)
    return 1.0 + extra_weight * ramp


class SpectLossComponents:
    """Aggregate spectral losses: the multi-resolution spectral L1 and NPOW
    losses and the mel loss, with the optional mean removal and masking
    noises.  `train_with_avg` and a (B, V, T) variants dimension follow the
    JAX package (variant 0, or the average of the scaled variant spectra for
    train_with_avg > 1)."""

    def __init__(self, training_config: Dict, preprocess_config: Dict, train_with_avg: Optional[int] = None):
        self.train_with_avg = train_with_avg
        self.preprocess_config = copy.deepcopy(preprocess_config)
        self.sample_rate = preprocess_config["sample_rate"]
        cfg = copy.deepcopy(training_config["spect_loss_config"])

        if "spect_loss_schedule" in cfg:
            sched = cfg.get("spect_loss_schedule")
            self.spect_loss_weight = None if sched is None else ParamSchedule(name="spect_loss_weight", **sched)
        elif "spect_loss_weight" in cfg:
            self.spect_loss_weight = ParamSchedule(name="spect_loss_weight", initial=cfg["spect_loss_weight"])
        else:
            self.spect_loss_weight = ParamSchedule(name="spect_loss_weight", initial=1.0)

        self.spect_error_gain = cfg.get("spect_error_gain", 1)
        self.NPOW_loss_weight = cfg.get("NPOW_loss_weight", 0) or 0
        self.mell_loss_weight = cfg.get("mell_loss_weight", 0) or 0
        self.masking_noise_level = cfg.get("masking_noise_std", 0)
        atten_db = cfg.get("rel_masking_noise_atten_db", None)
        self.rel_masking_noise_level = 10.0 ** (-abs(atten_db) / 20.0) if atten_db is not None else None
        self.remove_mean_hz = cfg.get("remove_mean_hz", None)
        self.mean_smoothing_win = None
        if self.remove_mean_hz:
            w = get_stft_window("nuttall4_6db", win_len=int(4 * self.sample_rate / self.remove_mean_hz),
                                dtype=np.float32)
            self.mean_smoothing_win = torch.from_numpy((w / np.sum(w)).astype(np.float32))

        # keep only resolutions with a non-zero loss_type
        if "loss_type" in cfg:
            keep = [bool(lt) for lt in cfg["loss_type"]]
            cfg["win_size"] = [w for k, w in zip(keep, cfg["win_size"]) if k]
            cfg["hop_size"] = [h for k, h in zip(keep, cfg["hop_size"]) if k]
            if "fft_over" in cfg and hasattr(cfg["fft_over"], "__getitem__"):
                cfg["fft_over"] = [f for k, f in zip(keep, cfg["fft_over"]) if k]
            self.spect_loss_type = [lt for lt in cfg["loss_type"] if lt]
            cfg["loss_type"] = self.spect_loss_type
        else:
            self.spect_loss_type = None

        self.stft_processor = None
        if (self.spect_loss_weight is not None) or self.NPOW_loss_weight > 0:
            self.stft_processor = MultiResStft(cfg, self.sample_rate)
            if self.spect_loss_type is None:
                self.spect_loss_type = [SPECT_LOSS_BIT] * len(self.stft_processor.win_len)
            lbe = cfg.get("low_band_extra_weight", 0)
            if lbe:
                lim = cfg.get("low_band_extra_weight_limit_Hz", 0)
                tr = cfg.get("low_band_extra_weight_transition_Hz", 500)
                self.low_band_extra_weight = [
                    torch.from_numpy(low_band_extra_weight_vector(lbe, fs * tr / self.sample_rate,
                                                                  fs * lim / self.sample_rate, fs // 2 + 1))
                    for fs in self.stft_processor.fft_size]
            else:
                self.low_band_extra_weight = [1.0 for _ in self.stft_processor.fft_size]

        self.mel_loss = None
        if self.mell_loss_weight > 0:
            ign_attn_db = 0 if (self.preprocess_config.get("lin_amp_off") or 0) > 0 else 40
            self.mel_loss = MelLoss(self.preprocess_config, ign_attn_db)

    @property
    def masking_draws(self) -> List[str]:
        """The names of the noise draws `calc_losses` takes, in the JAX
        package's order: each is a standard normal of the target's shape."""
        return ([k for k, on in (("rel_masking_noise", self.rel_masking_noise_level),
                                 ("masking_noise", self.masking_noise_level)) if on])

    def calc_spectral_error(self, ref_audio: torch.Tensor, gen_audio: torch.Tensor):
        """Returns (spect_loss, NPOW_loss) over the multi-resolution bank;
        gen_audio is (B, T) or (B, V, T)."""
        spect_error = 0.0 if self.spect_loss_weight is not None else None
        NPOW_error = 0.0 if self.NPOW_loss_weight else None
        spect_cnt = NPOW_cnt = 0
        n_variants = None
        if gen_audio.dim() == 3:
            if self.train_with_avg is None or self.train_with_avg <= 1:
                gen_audio = gen_audio[:, 0]
            else:
                B, n_variants, T = gen_audio.shape
                gen_audio = gen_audio.reshape(B * n_variants, T)

        def unfold_avg(sp):
            # (B*V, frames, bins) scaled spectrum -> variant-averaged (B, ...)
            if n_variants is None:
                return sp
            return torch.mean(sp.reshape(-1, n_variants, *sp.shape[1:]), dim=1)

        proc = self.stft_processor
        for ref_sp_c, syn_sp_c, lt, lbew in zip(proc.generate_stft(ref_audio), proc.generate_stft(gen_audio),
                                                self.spect_loss_type, self.low_band_extra_weight):
            if torch.is_tensor(lbew):
                lbew = lbew.to(ref_audio.device)
            if (self.spect_loss_weight is not None) and (lt & SPECT_LOSS_BIT):
                ref_sp = proc.scale_spec(ref_sp_c)
                syn_sp = unfold_avg(proc.scale_spec(syn_sp_c))
                spect_error = spect_error + torch.mean(torch.abs(syn_sp - ref_sp) * lbew)
                spect_cnt += 1
            if self.NPOW_loss_weight and (lt & NPOW_LOSS_BIT):
                ref_p = proc.scale_spec_man_select(ref_sp_c, magnitude_exponent=1)
                syn_p = unfold_avg(proc.scale_spec_man_select(syn_sp_c, magnitude_exponent=1))
                NPOW_error = NPOW_error + torch.mean(
                    torch.sqrt(torch.sum(torch.square(syn_p - ref_p) * lbew, dim=(1, 2)))
                    / torch.sqrt(torch.sum(torch.square(ref_p) * lbew, dim=(1, 2)) + _EPS * _EPS))
                NPOW_cnt += 1
        spect_loss_n = self.spect_error_gain * spect_error / spect_cnt if spect_cnt else None
        NPOW_loss_n = NPOW_error / NPOW_cnt if NPOW_cnt else None
        return spect_loss_n, NPOW_loss_n

    def calc_losses(self, in_audio: torch.Tensor, outputs: torch.Tensor,
                    noises: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Optional[torch.Tensor]]:
        """Dict of raw losses.  `noises` holds the draws `masking_draws` names
        (standard normals of in_audio's shape); without them the masking
        noises are not added, as the JAX package adds none without an rng."""
        if self.mean_smoothing_win is not None:
            kern = self.mean_smoothing_win.to(in_audio)
            k = kern.shape[0]
            padded = F.pad(in_audio[:, None], ((k - 1) // 2, k - 1 - (k - 1) // 2))
            in_audio = in_audio - F.conv1d(padded, kern[None, None])[:, 0]
        if noises is not None:
            if self.rel_masking_noise_level:
                rms = torch.sqrt(torch.mean(torch.square(in_audio), dim=1, keepdim=True))
                in_audio = in_audio + (rms * self.rel_masking_noise_level * noises["rel_masking_noise"]).detach()
            if self.masking_noise_level:
                in_audio = in_audio + self.masking_noise_level * noises["masking_noise"]
        spect_loss_n = NPOW_loss_n = mel_loss_n = None
        if self.stft_processor is not None:
            spect_loss_n, NPOW_loss_n = self.calc_spectral_error(in_audio, outputs)
        if self.mel_loss is not None:
            mel_loss_n = self.mel_loss(in_audio, outputs[:, 0] if outputs.dim() == 3 else outputs)
        return {"mel_loss": mel_loss_n, "spect_loss": spect_loss_n, "NPOW_loss": NPOW_loss_n}

    def total_loss(self, in_audio: torch.Tensor, outputs: torch.Tensor, step: int = 0,
                   noises: Optional[Dict[str, torch.Tensor]] = None):
        losses = self.calc_losses(in_audio, outputs, noises=noises)
        return self.combine(losses, step, in_audio.device), losses

    def combine(self, losses: Dict[str, Optional[torch.Tensor]], step: int, device) -> torch.Tensor:
        """The weighted sum of `calc_losses`'s losses at `step`.  Each is a
        batch mean of per-sample terms (the variants of one sample are
        averaged before the mean), so the loss of a batch split into equal
        shards is the mean of the shards' losses."""
        total = torch.zeros((), device=device)
        if losses["spect_loss"] is not None and self.spect_loss_weight is not None:
            total = total + losses["spect_loss"] * self.spect_loss_weight(step)
        if losses["mel_loss"] is not None:
            total = total + losses["mel_loss"] * self.mell_loss_weight
        if losses["NPOW_loss"] is not None:
            total = total + losses["NPOW_loss"] * self.NPOW_loss_weight
        return total


# ---------------------------------------------------------------- F0 losses


def _dilate_mask(mask: torch.Tensor, kernel_len: int) -> torch.Tensor:
    """Binary mask dilation by a ones-kernel conv, left then right."""
    kern = torch.ones((1, 1, kernel_len), dtype=mask.dtype, device=mask.device)
    left = F.conv1d(F.pad(mask[:, None], (kernel_len - 1, 0)), kern)
    return F.conv1d(F.pad(left, (0, kernel_len - 1)), kern)[:, 0]


def f0_pred_loss_mask(target_F0: torch.Tensor, limit_samples: int) -> torch.Tensor:
    """1 where the F0 prediction loss applies: voiced regions eroded by
    extending the unvoiced segments."""
    extended = _dilate_mask((target_F0 == 0).float(), limit_samples + 1)
    return (extended == 0).float()


def f0_rec_loss_mask(target_F0: torch.Tensor, limit_samples: int) -> torch.Tensor:
    """1 on the voiced segments extended into their unvoiced neighbourhoods."""
    extended = _dilate_mask((target_F0 != 0).float(), limit_samples + 1)
    return (extended != 0).float()


_F0_METHODS = {"L2": "L2", "l2": "L2", "least_squares": "L2", "L1": "L1", "l1": "L1", "RMSE": "RMSE", "rmse": "RMSE"}


def f0_prediction_loss_parts(pred_F0, target_F0, pred_mask, method="L1", uv_weight=None, rec_mask=None,
                             min_frequency=40.0):
    """(numerator, denominator) of the masked F0 regression loss: sums over
    the batch, whose weights count the voiced frames, so the loss couples
    the samples of a batch.  Sharded over ranks, the sums of all shards
    make the batch's (`finish_f0_prediction_loss`)."""
    if method not in _F0_METHODS:
        raise RuntimeError(f"unknown F0 loss method {method}")
    diff = torch.clamp(target_F0, min=min_frequency) - pred_F0[:, : target_F0.shape[1]]
    if uv_weight:
        prediction_loss_mask = pred_mask + (1 - rec_mask)
        diff = diff * prediction_loss_mask
        weight = torch.maximum(pred_mask, uv_weight * prediction_loss_mask)
    else:
        weight = pred_mask
    kind = _F0_METHODS[method]
    if kind == "L2":
        num = torch.sum(torch.square(diff * weight))
    elif kind == "L1":
        num = torch.sum(torch.abs(diff * weight))
    else:
        num = torch.sum(torch.square(diff) * weight)
    return num, torch.sum(weight)


def finish_f0_prediction_loss(num, den, method="L1", uv_weight=None):
    """The F0 loss from the batch's (numerator, denominator)."""
    ratio = num / torch.clamp(den, min=0.0 if uv_weight else 1.0)
    return torch.sqrt(ratio) if _F0_METHODS[method] == "RMSE" else ratio


def f0_prediction_loss(pred_F0, target_F0, pred_mask, method="L1", uv_weight=None, rec_mask=None,
                       min_frequency=40.0):
    """Masked F0 regression loss."""
    num, den = f0_prediction_loss_parts(pred_F0, target_F0, pred_mask, method, uv_weight, rec_mask, min_frequency)
    return finish_f0_prediction_loss(num, den, method, uv_weight)


def stft_coherence_loss_parts(signal_stft_coh, win_size, hop_size, fft_size, istft_window, stft_window):
    """(numerator, denominator) of the STFT coherence loss, sums over the
    batch: the loss is their ratio, a ratio of batch means (equal counts),
    which couples the samples of a batch."""
    sig = istft(signal_stft_coh, win_size, hop_size, fft_size, istft_window)
    back = stft(sig, win_size, hop_size, fft_size, stft_window)
    T = min(signal_stft_coh.shape[1], back.shape[1])
    a = torch.abs(signal_stft_coh[:, :T])
    b = torch.abs(back[:, :T])
    return torch.sum(torch.square(a - b)), torch.sum(torch.square(a))


def stft_coherence_loss(signal_stft_coh, win_size, hop_size, fft_size, istft_window, stft_window):
    """Penalise inconsistent (non-realisable) STFTs: resynthesise, re-analyse
    and compare magnitudes."""
    num, den = stft_coherence_loss_parts(signal_stft_coh, win_size, hop_size, fft_size, istft_window, stft_window)
    return num / den


def td_loss(signal: torch.Tensor, target: torch.Tensor, win_len: int) -> torch.Tensor:
    """Windowed time-domain loss: the mean absolute difference of the local
    RMS envelopes (frames of `win_len`, hop win_len // 2), so that a phase
    mismatch does not dominate."""
    def envelope(x):
        return torch.sqrt(torch.mean(torch.square(frame(x, win_len, win_len // 2)), dim=-1) + 1e-10)
    return torch.mean(torch.abs(envelope(signal) - envelope(target)))
