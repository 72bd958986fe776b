"""PaNWaveNet facade + mel-RMS normalisation.

Counterpart of the JAX package's models/pan_wavenet.py.  NormMelComponents
follows the JAX package's estimator (per-frame RMS from the mel-band
energies, or through the pseudo-inverse of the mel filterbank with
`normalize_use_pinv`), which deliberately departs from the TF reference's
num_smooth_iters==0 branch; then the optional floor (`max_norm_fact`),
compressor (`normalize_compressor_exp`) and iterative overlap-add smoothing
of the gain contour (`normalize_rms_num_smooth_iters`), whose smoothed
gain is then the output gain in place of the frames' linear interpolation.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..compat.params_io import params_from_jax
from ..dsp.mel import mel_filter, mel_frequencies
from ..dsp.windows import get_stft_window
from ..observability import MODEL_NORMMEL, span
from ..ops.interp import linear_interp_upsample
from ..ops.precision import exact_fp32
from ..ops.stft_ops import overlap_and_add
from .mbexwn import MBExWN

_EPS = 1e-7  # tf.keras.backend.epsilon()


class NormMelComponents(nn.Module):
    """Estimate frame RMS from the mel spectrogram, normalise the mel by it
    and return the upsampled RMS to re-apply as an output gain."""

    def __init__(self, preprocess_config: Dict, n_group: int = 1, max_norm_fact=None,
                 normalize_compressor_exp=None, lin_amp_scale: float = 1.0, lin_amp_off: float = 1.0e-5,
                 mel_amp_scale: float = 1.0, use_max_limit: bool = False, normalize_use_pinv: bool = False,
                 normalize_rms_num_smooth_iters: int = 0, normalize_smooth_win_scale: float = 1,
                 normalize_smooth_with_squared_win: bool = True, **_):
        super().__init__()
        self.spect_win_size = preprocess_config.get("win_size", preprocess_config["fft_size"])
        self.spect_hop_size = preprocess_config["hop_size"]
        if 4 * self.spect_hop_size != self.spect_win_size:
            raise RuntimeError("NormMelComponents: only win_size == 4*hop_size is supported")
        self.n_group = n_group
        self.rms_norm_fact = preprocess_config["fft_size"] * self.spect_win_size * 0.5
        mel_channels = preprocess_config["mel_channels"]
        self.use_pinv = normalize_use_pinv
        if normalize_use_pinv:
            self.win_norm = float(np.sqrt(np.sum(get_stft_window("hann", self.spect_win_size) ** 2)))
            mel_basis = mel_filter(sr=preprocess_config["sample_rate"], n_fft=preprocess_config["fft_size"],
                                   n_mels=mel_channels, fmin=preprocess_config["fmin"], fmax=preprocess_config["fmax"])
            self.register_buffer("mel_band_filter_inverted", torch.from_numpy(
                np.linalg.pinv(mel_basis).T.astype(np.float32)), persistent=False)
        else:
            mel_f = mel_frequencies(n_mels=mel_channels + 2, fmin=preprocess_config["fmin"],
                                    fmax=preprocess_config["fmax"])
            self.register_buffer("inv_enorm", torch.from_numpy(
                ((mel_f[2: mel_channels + 2] - mel_f[:mel_channels]) / 2.0).astype(np.float32)), persistent=False)
        self.num_smooth_iters = max(0, normalize_rms_num_smooth_iters or 0)
        self.max_norm_fact = max_norm_fact
        self.compressor_exp = normalize_compressor_exp
        self.use_max_limit = use_max_limit
        self.lin_amp_scale = lin_amp_scale
        self.lin_amp_off = lin_amp_off
        self.mel_amp_scale = mel_amp_scale
        # the smoothing's analysis window (to resample the gain at the frames) and overlap-add window
        win = get_stft_window("hann", self.spect_win_size)
        self.register_buffer("gwin", torch.from_numpy((win / np.sum(win)).astype(np.float32)), persistent=False)
        self.smooth_win_size = int(self.spect_win_size * normalize_smooth_win_scale)
        swin = get_stft_window("hann", self.smooth_win_size)
        self.register_buffer("smooth_syn_win", torch.from_numpy(swin ** 2 if normalize_smooth_with_squared_win
                                                                else swin), persistent=False)

    def estimate_rms(self, mel: torch.Tensor) -> torch.Tensor:
        """Per-frame RMS estimate (B, T) from linear-amplitude mel (B, T, C)."""
        if self.use_pinv:
            spec = torch.einsum("btc,cf->btf", mel, self.mel_band_filter_inverted) / self.win_norm
            return torch.sqrt(torch.sum(spec ** 2, dim=-1) / self.rms_norm_fact)
        return torch.sqrt(torch.sum((mel * self.inv_enorm) ** 2, dim=-1) / self.rms_norm_fact)

    def _smooth(self, rms: torch.Tensor, n_frames: int) -> torch.Tensor:
        """The iterative overlap-add smoothing: each iteration spreads the
        (edge-padded) frame gains with the smoothing window, normalises by
        the window's own overlap-add and resamples the result at the frames
        through the analysis window.  Returns (frame gains (B, T), the last
        iteration's sample-rate gain (B, L))."""
        hop, win, sws = self.spect_hop_size, self.spect_win_size, self.smooth_win_size
        swin = self.smooth_syn_win.to(rms.dtype)
        off = sws // 2 + 2 * hop - win // 2
        ones = rms.new_ones((1, rms.shape[1] + 4))
        norm_gain = overlap_and_add(ones[:, :, None] * swin, hop)[:, off:]
        gain = None
        for _ in range(self.num_smooth_iters):
            padded = torch.cat((rms[:, :1], rms[:, :1], rms, rms[:, -1:], rms[:, -1:]), dim=1)
            gain = overlap_and_add(padded[:, :, None] * swin, hop)[:, off:]
            gain = gain / torch.clamp(norm_gain, min=_EPS)
            rms = torch.nn.functional.conv1d(gain[:, None, :], self.gwin.to(rms.dtype)[None, None, :],
                                             stride=hop)[:, 0, :n_frames]
        return rms, gain

    def normalize_inputs_by_rms(self, audio: Optional[torch.Tensor], mell, synth_length: Optional[int] = None):
        """The JAX package's signature: (audio (B, T) or (B, T, n_group) or
        None, log-mel (B, T_mel, C), synth_length) -> (grp_audio (B, T/n_group,
        n_group) or None, normalized log-mel, upsampled rms (B, T/n_group, 1)):
        the audio divided by the rms it is synthesised with, the training
        target.  Synthesis passes audio=None."""
        if audio is not None:
            synth_length = audio.shape[1]
        elif synth_length is None:
            raise RuntimeError("normalize_inputs_by_rms: either audio or synth_length is needed")
        mel = torch.exp(mell)
        rms = self.estimate_rms(mel)
        if self.max_norm_fact:
            rms = torch.clamp(rms, min=float(np.float32(1.0 / self.max_norm_fact)))
        if self.compressor_exp is not None:
            rms = torch.pow(rms, self.compressor_exp)
        gain = None
        if self.num_smooth_iters:
            rms, gain = self._smooth(rms, mell.shape[1])
        rms_e = rms[:, :, None]
        mel = mel / torch.clamp(rms_e, min=_EPS) * self.lin_amp_scale
        if self.use_max_limit:
            mell_out = self.mel_amp_scale * torch.log(torch.clamp(mel, min=self.lin_amp_off))
        else:
            mell_out = self.mel_amp_scale * torch.log(mel + self.lin_amp_off)
        if gain is not None:
            off = self.spect_win_size // 2
            upsampled = torch.clamp(gain[:, off: off + synth_length], min=_EPS).reshape(mell.shape[0], -1,
                                                                                         self.n_group)
        else:
            upsampled = linear_interp_upsample(rms_e, self.spect_hop_size)
        target_t = synth_length // self.n_group
        if upsampled.shape[1] < target_t:
            upsampled = torch.cat((upsampled, upsampled[:, -1:].expand(-1, target_t - upsampled.shape[1], -1)), dim=1)
        elif upsampled.shape[1] > target_t:
            upsampled = upsampled[:, :target_t]
        grp_audio = None if audio is None else audio.reshape(audio.shape[0], -1, self.n_group) / upsampled
        return grp_audio, mell_out, upsampled


class PaNWaveNet(nn.Module):
    """Top-level model: mel -> waveform.  Its weights are those of `block`."""

    streamable = True  # causal or haloed chunks with the oscillator's phase carried (parallel/streaming.py)

    def __init__(self, model_config: Dict, training_config: Dict, preprocess_config: Dict, quiet: bool = True,
                 name: str = "myWaveGlow", **_):
        super().__init__()
        self.name = name
        self.model_config = copy.deepcopy(model_config)
        self.norm_mel_components = None
        if self.model_config.get("normalize_rms_from_mell", False):
            self.norm_mel_components = NormMelComponents(preprocess_config=preprocess_config, **model_config)
        self.sample_rate = preprocess_config["sample_rate"]
        self.mel_channels = preprocess_config["mel_channels"]
        self.segment_length = preprocess_config["segment_length"]
        self.spect_hop_size = preprocess_config["hop_size"]

        cfg = copy.deepcopy(model_config)
        for k in ("normalize_rms_from_mell", "normalize_rms_num_smooth_iters", "normalize_compressor_exp",
                  "normalize_smooth_win_scale", "normalize_smooth_with_squared_win", "normalize_use_pinv",
                  "max_norm_fact"):
            cfg.pop(k, None)
        if "ps_max_db_range" in cfg:
            # deprecated config name
            cfg["filter_max_db_range"] = cfg.pop("ps_max_db_range")
            if cfg.get("ns_max_db_range") != cfg["filter_max_db_range"]:
                raise RuntimeError("setting ns_max_db_range != ps_max_db_range is not supported")
            cfg.pop("ns_max_db_range", None)
        if "pulse_rate_factor" not in cfg:
            raise NotImplementedError("PaNWaveNet: required parameter pulse_rate_factor is missing in the model config")
        self.block = MBExWN(**cfg, preprocess_config=preprocess_config, quiet=quiet)

    # the two forms of the weights and the training route (models/mbexwn.py)

    def init(self, generator: torch.Generator, batch_size: int = 1, T_mel: int = 32) -> "PaNWaveNet":
        """The JAX package's `PaNWaveNet.init`, drawn from `generator` into the
        current form.  Batch size and T_mel are the JAX signature's: the
        shapes here are fixed at construction, so they change nothing."""
        self.block.init(generator)
        return self

    @property
    def trainable(self) -> bool:
        return self.block.trainable

    def trainable_(self) -> "PaNWaveNet":
        """The trainable form (v, g and the wavetables as parameters), in place."""
        self.block.trainable_()
        return self

    def fold_(self) -> "PaNWaveNet":
        """The folded (inference) form, in place."""
        self.block.fold_()
        return self

    def load_jax_params(self, flat: Dict) -> None:
        """Load flat JAX-layout params of the current form into the block.  With
        the noise channel off, block 0's folded start kernel drops the noise's
        input column if it has one: the shipped model with its noise at zero."""
        blk = self.block
        start = f"{blk.block_names[0]}/wavenet/start/kernel"
        if (not blk.pp_mod_subnet_noise_channel_sigma and start in flat
                and flat[start].shape[1] == blk.wn_in_channels + 1):
            flat = {**flat, start: flat[start][:, :-1]}
        blk.load_state_dict(params_from_jax(flat), strict=True)

    def set_differentiable(self, on: bool = True) -> None:
        """The training route (True: per-layer WaveNet, plain oscillator) or
        the kernels' (False, the default)."""
        self.block.set_differentiable(on)

    @property
    def has_components(self) -> bool:
        return True

    def noise_shape(self, batch: int, T_mel: int):
        """The shape of `infer`'s `noise` (the noise channel) for a mel of T_mel frames."""
        return batch, self.block.wn_input_length(T_mel), 1

    def noise(self, batch: int, T_mel: int, device) -> Optional[torch.Tensor]:
        """The noise channel `infer` draws for a (batch, T_mel) mel handed none,
        for callers that hold or split it (None with the channel off)."""
        if not self.block.pp_mod_subnet_noise_channel_sigma:
            return None
        return MBExWN.draw_noise(self.noise_shape(batch, T_mel), torch.float32, device)

    def prepare_mel(self, spect: torch.Tensor, synth_length: int = 0):
        """The mel (B, T, C) as the model sees it for `synth_length` samples
        (T * hop by default), extended by its last frame where short and
        RMS-normalised where the model normalises -> (mel, the upsampled RMS
        (B, synth_length, 1) or None)."""
        synth_length = synth_length or spect.shape[1] * self.spect_hop_size
        if spect.shape[1] * self.spect_hop_size < synth_length:
            spect = torch.cat((spect, spect[:, -1:]), dim=1)
        if self.norm_mel_components is None:
            return spect, None
        with span(MODEL_NORMMEL):
            _, spect, upsampled_rms = self.norm_mel_components.normalize_inputs_by_rms(None, spect, synth_length)
        return spect, upsampled_rms

    @exact_fp32()
    def infer(self, spect: torch.Tensor, synth_length: int = 0, F0: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
              phase_offset: Optional[torch.Tensor] = None, return_F0: bool = False,
              return_components: bool = False):
        """Generate sound (B, synth_length) from a log-mel spectrogram (B, T, C).
        As the JAX package's `infer`: with `return_F0`, (sound, PP), PP the
        block's control signals (`MBExWN.forward`'s return_PP) cut to
        synth_length; `return_components` puts the sound in a list."""
        synth_length = synth_length if synth_length else self.segment_length
        spect, upsampled_rms = self.prepare_mel(spect, synth_length)
        out = self.block(spect, F0=F0, noise=noise, generator=generator, phase_offset=phase_offset,
                         return_PP=return_F0)
        signal, PP = out if return_F0 else (out, None)
        signal = signal[:, :synth_length]
        if upsampled_rms is not None:
            signal = signal * upsampled_rms[:, :synth_length, 0]
        if return_F0:
            PP = [[name, value[:, :synth_length]] for name, value in PP]
            return ([signal], PP) if return_components else (signal, PP)
        return [signal] if return_components else signal

    @exact_fp32()
    def infer_components(self, spect: torch.Tensor, synth_length: int = 0, F0: Optional[torch.Tensor] = None,
                         transposition_factor: Optional[float] = None, noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """Decomposed inference, as the JAX package's `infer_components`:
        (F0 (B, T_mel*spect_to_pulse_ups), excitation (B, T_mel*hop),
        complex envelope filter (B, T_mel, fft//2+1), upsampled RMS (B, T) or
        None).  A given F0 sets synth_length to its length;
        `transposition_factor` scales the F0."""
        synth_length = synth_length if F0 is None else F0.shape[1]
        spect, upsampled_rms = self.prepare_mel(spect, synth_length)
        if upsampled_rms is not None:
            upsampled_rms = upsampled_rms[:, :, 0]
        if F0 is None:
            F0 = self.block.generate_f0(spect)
        if transposition_factor:
            F0 = transposition_factor * F0
        excitation = self.block.generate_excitation(spect, F0, noise=noise, generator=generator)
        specenv = self.block.generate_specenv(spect, F0)
        return F0, excitation, specenv, upsampled_rms
