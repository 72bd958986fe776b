"""PaNWaveNet facade + mel-RMS normalisation.

Counterpart of the JAX package's models/pan_wavenet.py.  NormMelComponents
follows the JAX package's estimator (per-frame RMS from the mel-band
energies), which deliberately departs from the TF reference's
num_smooth_iters==0 branch.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..dsp.mel import mel_frequencies
from ..ops.interp import linear_interp_upsample
from ..ops.precision import exact_fp32
from .mbexwn import MBExWN

_EPS = 1e-7  # tf.keras.backend.epsilon()


class NormMelComponents(nn.Module):
    """Estimate frame RMS from the mel spectrogram, normalise the mel by it
    and return the upsampled RMS to re-apply as an output gain."""

    def __init__(self, preprocess_config: Dict, n_group: int = 1, max_norm_fact=None,
                 normalize_compressor_exp=None, lin_amp_scale: float = 1.0, lin_amp_off: float = 1.0e-5,
                 mel_amp_scale: float = 1.0, use_max_limit: bool = False, normalize_use_pinv: bool = False,
                 normalize_rms_num_smooth_iters: int = 0, **_):
        super().__init__()
        self.spect_win_size = preprocess_config.get("win_size", preprocess_config["fft_size"])
        self.spect_hop_size = preprocess_config["hop_size"]
        if 4 * self.spect_hop_size != self.spect_win_size:
            raise RuntimeError("NormMelComponents: only win_size == 4*hop_size is supported")
        if normalize_rms_num_smooth_iters:
            raise NotImplementedError("the iterative RMS smoothing of NormMelComponents is not ported "
                                      "(ROADMAP.md queue 1, item 13)")
        if normalize_use_pinv or max_norm_fact or normalize_compressor_exp is not None or use_max_limit:
            raise NotImplementedError("NormMelComponents' pinv estimator, max_norm_fact, normalize_compressor_exp "
                                      "and use_max_limit are not ported (ROADMAP.md queue 1, item 13)")
        self.n_group = n_group
        self.rms_norm_fact = preprocess_config["fft_size"] * self.spect_win_size * 0.5
        mel_channels = preprocess_config["mel_channels"]
        mel_f = mel_frequencies(n_mels=mel_channels + 2, fmin=preprocess_config["fmin"], fmax=preprocess_config["fmax"])
        self.register_buffer("inv_enorm", torch.from_numpy(
            ((mel_f[2: mel_channels + 2] - mel_f[:mel_channels]) / 2.0).astype(np.float32)), persistent=False)
        self.lin_amp_scale = lin_amp_scale
        self.lin_amp_off = lin_amp_off
        self.mel_amp_scale = mel_amp_scale

    def estimate_rms(self, mel: torch.Tensor) -> torch.Tensor:
        """Per-frame RMS estimate (B, T) from linear-amplitude mel (B, T, C)."""
        return torch.sqrt(torch.sum((mel * self.inv_enorm) ** 2, dim=-1) / self.rms_norm_fact)

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
        rms_e = self.estimate_rms(mel)[:, :, None]
        mel = mel / torch.clamp(rms_e, min=_EPS) * self.lin_amp_scale
        mell_out = self.mel_amp_scale * torch.log(mel + self.lin_amp_off)
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

    def set_differentiable(self, on: bool = True) -> None:
        """The training route (True: per-layer WaveNet, plain oscillator) or
        the kernels' (False, the default)."""
        self.block.set_differentiable(on)

    @exact_fp32()
    def infer(self, spect: torch.Tensor, synth_length: int = 0, F0: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
              phase_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Generate sound (B, synth_length) from a log-mel spectrogram (B, T, C)."""
        synth_length = synth_length if synth_length else self.segment_length
        if spect.shape[1] * self.spect_hop_size < synth_length:
            spect = torch.cat((spect, spect[:, -1:]), dim=1)
        upsampled_rms = None
        if self.norm_mel_components is not None:
            _, spect, upsampled_rms = self.norm_mel_components.normalize_inputs_by_rms(None, spect, synth_length)
        signal = self.block(spect, F0=F0, noise=noise, generator=generator, phase_offset=phase_offset)
        out = signal[:, :synth_length]
        if upsampled_rms is not None:
            out = out * upsampled_rms[:, :synth_length, 0]
        return out
