"""MELInverter: the high-level inference facade.

Counterpart of the JAX package's mel_inverter.py.  Loads a model directory
(config.yaml + weights.npz), rescales external mel spectrograms into the
model's convention, and synthesises on one device: the card by default
(`device="cuda"`), the CPU only when the caller asks for it.  Mels are
edge-padded to length buckets and the padded audio tail is trimmed, as in
the JAX package, so a serving loop sees a few shapes only.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Union

import numpy as np
import torch
from scipy.interpolate import interp1d

from . import get_config_file
from .compat.params_io import flatten, load_params, params_from_jax
from .config import read_config
from .models.factory import create_model
from .ops.conv import fold_weight_norm

_DEF_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096)
log_to_db = 20 * np.log10(np.exp(1))


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device without a card raises (no silent
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class MELInverter:
    def __init__(self, model_id_or_path: Optional[str] = None, verbose: bool = False,
                 length_buckets=_DEF_BUCKETS, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = None
        self.model_id_or_path = model_id_or_path
        self.config_file = None
        self.preprocess_config = None
        self.mel_channels = None
        self.hop_size = None
        self.fft_size = None
        self.fmin = None
        self.fmax = None
        self._srate = None
        self.win_len = None
        self.lin_amp_scale = 1
        self.lin_amp_off = 1.0e-5
        self.mel_amp_scale = 1
        self.use_max_limit = False
        self.length_buckets = tuple(sorted(length_buckets))
        if model_id_or_path:
            self.load_model(model_id_or_path=model_id_or_path, verbose=verbose)

    @property
    def srate(self):
        return self._srate

    # ------------------------------------------------------------- mel prep

    def scale_mel(self, mel_config: Dict, verbose=False) -> np.ndarray:
        """Rescale an external `.mell` dict into the model's convention."""
        if mel_config["fmin"] != self.fmin:
            raise RuntimeError(f"mell fmin {mel_config['fmin']} does not match model fmin {self.fmin}")
        if ((mel_config["fmax"] is None) and self.fmax != mel_config["sr"] / 2) or (
                (mel_config["fmax"] is not None) and mel_config["fmax"] != self.fmax):
            raise RuntimeError(f"mell fmax {mel_config['fmax']} does not match model fmax {self.fmax}")

        if "mell" in mel_config:
            log_mel_spectrogram = np.array(mel_config["mell"].T[np.newaxis], dtype=np.float64)
            if mel_config.get("log_spec_offset", 0) != 0:
                log_mel_spectrogram -= mel_config["log_spec_offset"]
            if mel_config.get("log_spec_scale", 1) != 1:
                log_mel_spectrogram /= mel_config["log_spec_scale"]
            mel_spectrogram = np.exp(log_mel_spectrogram)
        elif "mel" in mel_config:
            mel_spectrogram = np.array(mel_config["mel"].T[np.newaxis])
        else:
            raise RuntimeError("error::no supported mel spectrum (keys: mell or mel) in mel_config")

        dd_n_fft = mel_config.get("nfft") or mel_config.get("n_fft") or mel_config.get("fft_size")
        fft_scale_factor = self.fft_size // dd_n_fft
        if fft_scale_factor != 1:
            mel_spectrogram *= fft_scale_factor
        if mel_config.get("lin_spec_offset") not in (None, 0):
            mel_spectrogram -= mel_config["lin_spec_offset"]
        if mel_config.get("lin_spec_scale", 1) != 1:
            mel_spectrogram /= mel_config["lin_spec_scale"]
        if self.lin_amp_scale != 1:
            mel_spectrogram *= self.lin_amp_scale
        if self.use_max_limit:
            mell = np.log(np.fmax(mel_spectrogram, self.lin_amp_off)).astype(np.float32)
        else:
            mell = np.log(mel_spectrogram + self.lin_amp_off).astype(np.float32)
        if verbose:
            print(f"    stats conditioning mell:: mean: {log_to_db * np.mean(mell):.3f}dB, "
                  f"max: {log_to_db * np.max(mell):.3f}dB, min: {log_to_db * np.min(mell):.3f}dB "
                  f"mell.shape {mell.shape}", file=sys.stderr)

        # hop-size adaptation by time interpolation
        if np.abs((mel_config["hoplen"] / mel_config["sr"]) / (self.hop_size / self.srate) - 1) > 0.001:
            if verbose:
                print(f"ATTENTION::interpolate mel spectrum to adapt hop size from "
                      f"{mel_config['hoplen'] / mel_config['sr']} to {self.hop_size / self.srate}", file=sys.stderr)
            mell = interp1d(np.arange(mell.shape[1]) * mel_config["hoplen"] / mel_config["sr"], mell, axis=1,
                            bounds_error=False, fill_value="extrapolate")(
                np.arange(0, (mell.shape[1] - 1 + 0.1) * mel_config["hoplen"] / mel_config["sr"],
                          self.hop_size / self.srate)).astype(np.float32)
        return mell * self.mel_amp_scale

    # ------------------------------------------------------------ synthesis

    def _bucket_len(self, T: int) -> int:
        for b in self.length_buckets:
            if T <= b:
                return b
        return T

    def noise_shape(self, scaled_mell: np.ndarray):
        """Shape of the noise channel `synth_from_mel` draws for this mel
        (it depends on the padded bucket length)."""
        T_pad = self._bucket_len(scaled_mell.shape[1])
        return scaled_mell.shape[0], self.model.block.wn_input_length(T_pad), 1

    def warm(self, buckets=None, batch_size: int = 1) -> None:
        """Run one synthesis per length bucket (all configured buckets by
        default): builds the CUDA kernels and lets cuDNN pick its algorithms
        before serving."""
        for b in buckets or self.length_buckets:
            self.synth_from_mel(np.full((batch_size, b, self.mel_channels), -10.0, dtype=np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def synth_from_mel(self, scaled_mell: np.ndarray, noise: Optional[np.ndarray] = None) -> np.ndarray:
        """Mel (B, T, C) -> waveform (B*T*hop,) raveled like the reference.

        `noise` (see `noise_shape`) replaces the noise channel's draw, which
        is otherwise the same for every call (a generator seeded 0)."""
        T = scaled_mell.shape[1]
        T_pad = self._bucket_len(T)
        if T_pad != T:
            # edge-pad with the last frame; only the trimmed tail sees it
            pad = np.repeat(scaled_mell[:, -1:], T_pad - T, axis=1)
            mell_in = np.concatenate([scaled_mell, pad], axis=1)
        else:
            mell_in = scaled_mell
        x = torch.from_numpy(np.ascontiguousarray(mell_in, dtype=np.float32)).to(self.device)
        nz = None if noise is None else torch.from_numpy(np.array(noise, dtype=np.float32)).to(self.device)
        with torch.inference_mode():
            y = self.model.infer(x, synth_length=T_pad * self.hop_size, noise=nz)
        return y[:, : T * self.hop_size].cpu().numpy().ravel()

    # -------------------------------------------------------------- loading

    def load_model(self, model_id_or_path, verbose=False):
        config_file = get_config_file(model_id_or_path)
        self.config_file = config_file
        model_dir = os.path.dirname(config_file)
        hparams = read_config(config_file)
        self.preprocess_config = hparams["preprocess_config"]
        model, _ = create_model(hparams, hparams["training_config"], self.preprocess_config, quiet=not verbose)
        weights_npz = os.path.join(model_dir, "weights.npz")
        if not os.path.exists(weights_npz):
            raise FileNotFoundError(f"no weights.npz in {model_dir}")
        if verbose:
            print(f"restore from {weights_npz}", file=sys.stderr)
        state = params_from_jax(flatten(fold_weight_norm(load_params(weights_npz))))
        model.block.load_state_dict(state, strict=True)
        self.model = model.eval().to(self.device)

        self.mel_channels = self.preprocess_config["mel_channels"]
        self.hop_size = self.preprocess_config["hop_size"]
        self.fft_size = self.preprocess_config["fft_size"]
        self.fmin = self.preprocess_config["fmin"]
        self.fmax = self.preprocess_config["fmax"]
        self._srate = self.preprocess_config["sample_rate"]
        self.win_len = self.preprocess_config.get("win_size", self.fft_size)
        self.lin_amp_scale = self.preprocess_config.get("lin_amp_scale", 1)
        self.lin_amp_off = self.preprocess_config.get("lin_amp_off", 1.0e-5)
        if self.lin_amp_off is None:
            self.lin_amp_off = 1.0e-5
        self.mel_amp_scale = self.preprocess_config.get("mel_amp_scale", 1)
        self.use_max_limit = bool(self.preprocess_config.get("use_max_limit", False))
