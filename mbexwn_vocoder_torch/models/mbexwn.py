"""MBExWN generator, inference path: F0 predictor -> wavetable excitation ->
gated WaveNet reshaping -> PQMF synthesis -> cepstral spectral-envelope
filter applied in the STFT domain.

Counterpart of the JAX package's models/mbexwn.py.  Tensors keep the JAX
package's (B, T, C) layout.  The noise channel takes an explicit `noise`
tensor or a `torch.Generator`: the JAX package draws
`jax.random.normal(PRNGKey(0))`, a stream torch cannot reproduce, so a test
that compares the two draws the noise once and hands it to both.

`force_causal` (the mode of live streaming, parallel/streaming.py) moves
every pad to the left: CAUSAL subnets and CAUSAL WaveNet stacks, with the
same parameters as the non-causal model.

Every config branch of the JAX package's model is taken, registry models'
or not, with the JAX package's parameter tree:
- the oscillator: wavetables (sinusoidal ones with `use_sinusoid`) through
  `ops.oscillator.oscillate`, the kernel on a CUDA tensor; the analytic
  `use_sinusoid_as_fun` pulse from the phase alone (`oscillator_phase`,
  bit-equal to the kernel's, without the kernel, which computes the table
  lookup only); `add_subharm_chans` sine channels from the phase the
  kernel returns with the audio, interleaved per sample as JAX folds them;
  `oscillate_with_pulse_gains` with the pulse-synchronous gain holds;
- the fold to the WaveNet rate: a reshape, or a PQMF analysis
  (`pulse_channels_use_pqmf`), which decimates by its own subband count
  (`wn_fold_factor`);
- after the post net, PQMF synthesis (the post net, the multiband gains and
  the synthesis as one stage, `ops.post_pqmf`: K3 on a CUDA tensor, its
  plain version on the CPU and on the training route) or a depth-to-time
  reshape (`pp_mod_subnet_use_pqmf: false`);
- the envelope: the cepstral STFT filter (with or without F0-adaptive
  cepstral windows, range limit, the cepstral-loss constraint, energy
  preservation, a zero-padded FFT), per-subband gains instead
  (`ps_use_stft: false`), or none (`ps_off`).

`differentiable` (set by the trainer through `PaNWaveNet.set_differentiable`)
selects the training route: the oscillator runs `oscillate_plain`, the port
of the JAX package's XLA oscillator, with gradients to the F0 and to the
wavetables, the WaveNet stacks run layer by layer (nn/wavenet.py), and the
post net and PQMF synthesis run `post_pqmf_plain`.
`remat_wavenet_blocks` recomputes each WaveNet block in the backward pass
on that route (`torch.utils.checkpoint`) instead of keeping its
activations.  The wavetables are a buffer in the folded (inference) form
and a parameter in the trainable one, under the same state_dict key: the
JAX trainer updates them with every other leaf of its parameter tree.
"""
from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..dsp.db import log_to_db
from ..dsp.pqmf import pqmf_filters
from ..dsp.wavetable import WavetableSpec, build_wavetable_grid
from ..dsp.windows import hann_periodic
from ..nn.layers import Activation, Conv1DWeightNorm, LinInterpLayer
from ..nn.subnet import generate_subnet_from_specs
from ..nn.wavenet import WaveNetAEBlock, resolve_dtype
from ..observability import (MODEL_ENVELOPE, MODEL_EXCITATION, MODEL_F0_NET, MODEL_POST_PQMF, MODEL_WAVENET,
                             span)
from ..ops.oscillator import (oscillate, oscillate_plain, oscillator_phase, pulse_sync_gain_avg as gain_avg,
                              pulse_sync_gain_hold as gain_hold, sinusoid_pulse, subharmonics)
from ..ops.pqmf_ops import pqmf_analysis
from ..ops.post_pqmf import post_pqmf, post_pqmf_plain
from ..ops.precision import exact_fp32
from ..ops.stft_ops import inverse_stft_window, istft, rdft, stft

# config keys that only the trainer reads; inference accepts and ignores them
_TRAINING_ONLY_KEYS = {
    "pp_teacher_forcing_schedule", "pp_F0_pred_loss_limits_ms", "pp_F0_rec_loss_limits_ms",
    "pp_F0_loss_weight", "pp_F0_loss_method", "pp_F0_UV_loss_weight", "pp_subnet_exclude_from_pretrain",
    "pp_subnet_suppress_uv_gradient", "psns_cepstral_loss_weight", "stft_coh_loss_weight", "dump_controls",
}


def _dtype_pref(env_name, config_value):
    """Env var > config key > fp32; an empty env value forces fp32."""
    env = os.environ.get(env_name)
    if env is not None:
        return resolve_dtype(env or None)
    return resolve_dtype(config_value or None)


class MBExWN(nn.Module):
    """Synthesize audio from mel spectrograms via a multi-band excited WaveNet."""

    def __init__(
        self,
        preprocess_config: Dict,
        pp_subnet,
        ps_subnet,
        pp_mod_subnet: Dict,
        pp_mod_subnet_upsampling_factors: List[int],
        pp_mod_subnet_channel_factors: List[int],
        multi_band_config: Dict,
        pp_min_frequency: float = 40.0,
        pp_max_frequency: float = 600.0,
        pp_activation: str = "soft_sigmoid",
        pp_mod_subnet_noise_channel_sigma: float = 0.5,
        pp_mod_subnet_use_pqmf: bool = True,
        pp_subnet_use_valid_padding: bool = False,
        pp_subnet_training_only: bool = False,
        ps_max_ceps_coefs: int = 120,
        ps_env_order_scale=None,
        ps_subnet_use_valid_padding: bool = False,
        ps_use_stft: bool = True,
        ps_off: bool = False,
        filter_max_db_range=None,
        psns_gain_loss_weight=None,
        psns_use_cepstral_loss_constraint: bool = False,
        spect_filters_preserve_energy: bool = False,
        remove_inactive_pad_layers: bool = False,
        use_prelu: bool = True,
        pulse_rate_factor: int = 2,
        pulse_channels: int = 8,
        pulse_channels_use_pqmf: bool = False,
        pulse_channels_multi_band_config=None,
        force_causal: bool = False,
        wavetable_config: Dict = None,
        alpha: float = 0.2,
        internal_win_size_s=None,
        internal_fft_over: int = 0,
        pulse_noise_floor_db=-90,
        name: str = "MBExWNGen",
        quiet: bool = True,
        wn_compute_dtype=None,
        subnet_compute_dtype=None,
        remat_wavenet_blocks: bool = False,
        **training_only,
    ):
        super().__init__()
        unknown = set(training_only) - _TRAINING_ONLY_KEYS
        if unknown:
            raise TypeError(f"MBExWN: unexpected config keys {sorted(unknown)}")
        wavetable_config = dict(wavetable_config or {})

        self.name = name
        self.sample_rate = preprocess_config["sample_rate"]
        self.spect_hop_size = preprocess_config["hop_size"]
        self.mel_channels = preprocess_config["mel_channels"]
        self.multi_band_config = copy.deepcopy(multi_band_config)
        self.mb_factor = self.multi_band_config["subbands"]
        self.pulse_rate = self.sample_rate / pulse_rate_factor
        self.pulse_channels = pulse_channels
        self.pulse_channels_use_pqmf = pulse_channels_use_pqmf
        self.pulse_channels_multi_band_config = copy.deepcopy(pulse_channels_multi_band_config)
        self.spect_to_subband_upsampling_factor = self.spect_hop_size // self.mb_factor
        self.spect_to_pulse_upsampling_factor = (
            self.spect_to_subband_upsampling_factor * pulse_channels) // int(np.prod(pp_mod_subnet_upsampling_factors))
        self.F0_down_sampling_factor = int(self.sample_rate // self.pulse_rate)
        self.pp_min_frequency = pp_min_frequency
        self.pp_max_frequency = pp_max_frequency
        self.subnet_compute_dtype = _dtype_pref("MBEXWN_SUBNET_DTYPE", subnet_compute_dtype)
        self.wn_compute_dtype = _dtype_pref("MBEXWN_WN_DTYPE", wn_compute_dtype)
        self.pp_subnet_training_only = pp_subnet_training_only
        self.remat_wavenet_blocks = remat_wavenet_blocks
        self.differentiable = False

        self.pp_subnet = None
        if pp_subnet:
            self.pp_subnet, _ = generate_subnet_from_specs(
                pp_subnet, base_name="PulsPar", in_channels=self.mel_channels, final_n_channels=1, final_nks=1,
                final_activation=pp_activation, force_causal=force_causal, pad_to_valid=pp_subnet_use_valid_padding,
                target_ups=self.spect_to_pulse_upsampling_factor,
                remove_inactive_pad_layers=remove_inactive_pad_layers, use_prelu=use_prelu, alpha=alpha)
        if pp_subnet_training_only:
            # the F0 subnet alone, for its pretraining
            return

        ups_prod = int(np.prod(pp_mod_subnet_upsampling_factors))
        if self.pulse_rate / pulse_channels * ups_prod * self.mb_factor != self.sample_rate:
            raise RuntimeError(
                f"MBExWN::config_error::the generated sample rate "
                f"{self.pulse_rate / pulse_channels * ups_prod * self.mb_factor} != {self.sample_rate}")

        # wavetable oscillator: the grid's constants; the tables themselves
        # are a weight ("wavetables") and come with the state_dict
        self.wavetable: WavetableSpec = build_wavetable_grid(sample_rate=self.pulse_rate, quiet=quiet,
                                                             **wavetable_config)
        self.register_buffer("wavetables", torch.from_numpy(self.wavetable.wavetables.copy()))
        # the excitation's dither against zero STFT magnitudes in training
        self.pulse_noise_floor_mag = None if pulse_noise_floor_db is None else 10 ** (-abs(pulse_noise_floor_db) / 20)

        # spectral-envelope subnet + cepstral machinery
        self.ps_use_stft = ps_use_stft
        self.ps_off = ps_off
        self.filter_max_log_range = None if filter_max_db_range is None else filter_max_db_range / log_to_db
        self.psns_gain_loss_weight = psns_gain_loss_weight
        self.psns_use_cepstral_loss_constraint = psns_use_cepstral_loss_constraint
        self.spect_filters_preserve_energy = spect_filters_preserve_energy

        if internal_win_size_s:
            self.stft_win_size = int(internal_win_size_s * self.sample_rate)
        else:
            self.stft_win_size = 4 * self.spect_hop_size
        fft_size = 16
        while fft_size < self.stft_win_size:
            fft_size *= 2
        self.fft_size = fft_size * 2 ** internal_fft_over
        stft_window = hann_periodic(self.stft_win_size)
        self.register_buffer("stft_window", torch.from_numpy(stft_window), persistent=False)
        self.register_buffer("istft_window", torch.from_numpy(
            inverse_stft_window(self.stft_win_size, self.spect_hop_size, stft_window)), persistent=False)
        # F0 smoothing for the cepstral-window select: bartlett without its
        # boundary zeros
        smooth_win = np.bartlett(2 * self.spect_hop_size + 3)[1:-1]
        self.register_buffer("frequency_smoothing_kernel", torch.from_numpy(
            (smooth_win / np.sum(smooth_win)).astype(np.float32)), persistent=False)

        self.ps_max_ceps_coefs = ps_max_ceps_coefs
        self.ps_subnet = self.ps_gain_interpolator = None
        if not ps_off:
            # the cepstrum of the envelope, or one log gain per subband
            self.ps_subnet, _ = generate_subnet_from_specs(
                ps_subnet, base_name="PS", in_channels=self.mel_channels, final_nks=1,
                final_n_channels=ps_max_ceps_coefs if ps_use_stft else self.mb_factor, final_activation=None,
                force_causal=force_causal, pad_to_valid=ps_subnet_use_valid_padding, weight_init_scale=0.01,
                remove_inactive_pad_layers=remove_inactive_pad_layers, use_prelu=use_prelu, alpha=alpha)
            if not ps_use_stft:
                self.ps_gain_interpolator = LinInterpLayer(self.spect_hop_size, num_pad_end=1,
                                                           name="ps_gain_interp")
        windows = log10f0 = None
        if not ps_off and ps_use_stft and ps_env_order_scale:
            # 30 log-spaced half-hamming cepstral windows, one per F0 step
            windows, log10f0 = [], []
            for f0 in np.logspace(np.log10(pp_min_frequency), np.log10(pp_max_frequency), 30):
                win_len = int(ps_env_order_scale * 0.5 * self.sample_rate / f0)
                if (win_len // 2) * 2 == win_len:
                    win_len += 1
                log10f0.append(np.log10(f0))
                half = np.hamming(win_len)[win_len // 2:]
                if win_len // 2 + 1 > ps_max_ceps_coefs:
                    windows.append(half[:ps_max_ceps_coefs])
                else:
                    windows.append(np.concatenate((half, np.zeros(ps_max_ceps_coefs - 1 - (win_len // 2)))))
            log10f0 = torch.from_numpy(np.asarray(log10f0, dtype=np.float32))
            windows = torch.from_numpy(np.asarray(windows, dtype=np.float32))
        self.register_buffer("ps_cepstral_windows_log10f0", log10f0, persistent=False)
        self.register_buffer("ps_cepstral_windows", windows, persistent=False)

        # WaveNet blocks
        pp_mod = copy.deepcopy(pp_mod_subnet)
        if force_causal:
            pp_mod["padding"] = "CAUSAL"
        self.pp_mod_subnet_noise_channel_sigma = pp_mod_subnet_noise_channel_sigma
        n_channels = pp_mod.pop("n_channels")
        cond_lin = pp_mod.pop("cond_lin_upsampling", 16)
        cond_ks = pp_mod.pop("cond_kernel_size", 3)
        self.block_names = []
        in_channels = self.wn_in_channels
        curr_pulse_rate = self.pulse_rate / self.pulse_channels
        spect_rate = self.sample_rate / self.spect_hop_size
        for iwn, (ups, chan_fac) in enumerate(zip(pp_mod_subnet_upsampling_factors, pp_mod_subnet_channel_factors)):
            if curr_pulse_rate != (curr_pulse_rate // (spect_rate * cond_lin)) * spect_rate * cond_lin:
                raise RuntimeError(
                    f"MBExWN::config_error:: cannot achieve conditioning rate {curr_pulse_rate} by integer "
                    f"upsampling of spectrum rate {spect_rate} with linear up {cond_lin}")
            block_name = f"PP_waveNetBlock_ups{ups}_{iwn}"
            self.add_module(block_name, WaveNetAEBlock(
                in_channels, self.mel_channels, n_channels=int(n_channels * chan_fac),
                up_sample=None if ups <= 1 else True, up_down_factor=ups, cond_kernel_size=cond_ks,
                cond_conv_upsampling=int(curr_pulse_rate // (spect_rate * cond_lin)), cond_lin_upsampling=cond_lin,
                compute_dtype=self.wn_compute_dtype, tp_axis=os.environ.get("MBEXWN_TP_AXIS") or None,
                name=block_name, **pp_mod))
            self.block_names.append(block_name)
            in_channels = pp_mod["n_out_channels"]
            curr_pulse_rate *= ups
        self.block_spans = [MODEL_WAVENET + name for name in self.block_names]  # each block's span name
        self.wn_post_net = Conv1DWeightNorm(in_channels, self.mb_factor, 1, name="wn_post_net")

        # the PQMF banks, WIO -> OIW: synthesis (1, used, taps+1), the pulse fold's analysis (subbands, 1, taps+1)
        syn = ana = None
        if pp_mod_subnet_use_pqmf:
            mb = self.multi_band_config
            _, syn = pqmf_filters(mb["subbands"], mb["taps"], mb["cutoff_ratio"], mb["beta"], mb.get("max_band"))
            syn = torch.from_numpy(np.ascontiguousarray(syn.transpose(2, 1, 0)))
        if pulse_channels_use_pqmf:
            c = self.pulse_channels_multi_band_config
            ana, _ = pqmf_filters(c["subbands"], c["taps"], c["cutoff_ratio"], c["beta"], c.get("max_band"))
            ana = torch.from_numpy(np.ascontiguousarray(ana.transpose(2, 1, 0)))
        self.register_buffer("pqmf_synthesis_filter", syn, persistent=False)
        self.register_buffer("pulse_pqmf_analysis_filter", ana, persistent=False)

    @property
    def wn_fold_factor(self) -> int:
        """Time decimation from the pulse rate to the WaveNet input rate: the
        reshape fold's pulse_channels, or the PQMF fold's subband count."""
        if self.pulse_channels_use_pqmf:
            return self.pulse_channels_multi_band_config["subbands"]
        return self.pulse_channels

    @property
    def wn_in_channels(self) -> int:
        """Folded pulse channels, the subharmonic channels and the optional
        noise channel."""
        return (self.wn_fold_factor + self.pulse_channels * self.wavetable.add_subharm_chans
                + (1 if self.pp_mod_subnet_noise_channel_sigma else 0))

    def wn_input_length(self, T_mel: int) -> int:
        """Time steps entering the first WaveNet block (the noise's length)."""
        return T_mel * self.spect_to_pulse_upsampling_factor // self.wn_fold_factor

    # ------------------------------------------------ parameters: init, forms

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX package's initialisation (`MBExWN.init`), drawn from
        `generator` into the current form: every conv and PReLU, and the
        wavetables of the wavetable grid.  torch cannot draw the JAX PRNG's
        numbers, so only the distributions match."""
        for m in self.modules():
            if isinstance(m, (Conv1DWeightNorm, Activation)):
                m.init(generator)
        if not self.pp_subnet_training_only:
            self.wavetables.copy_(torch.from_numpy(self.wavetable.wavetables))

    @property
    def trainable(self) -> bool:
        """True once every weight-normalised conv holds (v, g) (`trainable_`)."""
        return all(m.trainable for m in self.modules() if isinstance(m, Conv1DWeightNorm) and m.use_weight_norm)

    def trainable_(self) -> "MBExWN":
        """The trainable form, in place: every conv holds (v, g), and the
        wavetables become a parameter (the JAX trainer updates them)."""
        for m in self.modules():
            if isinstance(m, Conv1DWeightNorm):
                m.trainable_()
        if "wavetables" in self._buffers:
            self.wavetables = nn.Parameter(self._buffers.pop("wavetables"))
        return self

    def fold_(self) -> "MBExWN":
        """The folded (inference) form, in place: the convs hold their folded
        kernels, the wavetables are a buffer again, and the stacks and the
        oscillator are back on the kernels' route."""
        self.set_differentiable(False)
        for m in self.modules():
            if isinstance(m, Conv1DWeightNorm):
                m.fold_()
        if "wavetables" in self._parameters:
            self.register_buffer("wavetables", self._parameters.pop("wavetables").detach())
        return self

    def set_differentiable(self, on: bool = True) -> None:
        """Select the training route (True) or the kernels' (False) for the
        oscillator and every WaveNet stack."""
        for m in self.modules():
            if hasattr(m, "differentiable"):
                m.differentiable = on

    # ------------------------------------------------------------- subpaths

    def _run_subnet(self, subnet, mel):
        """Run a conditioning subnet in the subnet compute dtype, cast back."""
        dt = self.subnet_compute_dtype
        if dt is None:
            return subnet(mel)
        return subnet(mel.to(dt)).to(mel.dtype)

    def generate_f0(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, T_mel, C) -> (B, T_mel*spect_to_pulse_ups) F0 contour in Hz."""
        T_out = mel.shape[1] * self.spect_to_pulse_upsampling_factor
        with span(MODEL_F0_NET):
            if self.pp_subnet is not None:
                x = self._run_subnet(self.pp_subnet, mel)
                f0 = x[:, :, 0] * (self.pp_max_frequency - self.pp_min_frequency) + self.pp_min_frequency
                return f0[:, :T_out]
            return torch.full((mel.shape[0], T_out), float(self.pp_max_frequency), dtype=mel.dtype,
                              device=mel.device)

    def _excite(self, pulse_frequency: torch.Tensor, phase_offset: Optional[torch.Tensor], return_phase: bool):
        """(audio (B, T), phase (B, T) or None) of the oscillator: the analytic
        pulse from the phase alone (`use_sinusoid_as_fun`), else the
        wavetables through `oscillate` (the kernel on a CUDA tensor, the
        plain version on the training route), which returns the phase from
        the same launch when it is asked for."""
        wt = self.wavetable
        if wt.use_sinusoid_as_fun:
            phase = oscillator_phase(pulse_frequency, wt.sample_rate, phase_offset)
            return sinusoid_pulse(phase), phase
        fn = oscillate_plain if self.differentiable else oscillate
        out = fn(pulse_frequency, self.wavetables, wt.nominalF0, wt.F0GridFactor, wt.min_transposition,
                 wt.max_transposition, wt.sample_rate, phase_offset=phase_offset, return_phase=return_phase)
        return out if return_phase else (out, None)

    def oscillate(self, pulse_frequency: torch.Tensor, phase_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Oscillator: F0 (B, T12k) -> excitation (B, T12k), or (B, T12k,
        1 + n) with `add_subharm_chans = n` (the pulse, then sin(2 pi phase
        / k) for k = 2 ... n + 1).

        phase_offset (B,): absolute phase (mod 1) just before the first
        sample, the carry of chunked synthesis.  The training route runs the
        plain version, which is differentiable."""
        n_sub = self.wavetable.add_subharm_chans
        audio, phase = self._excite(pulse_frequency, phase_offset, return_phase=bool(n_sub))
        if not n_sub:
            return audio
        return torch.stack([audio] + subharmonics(phase, n_sub), dim=-1)

    def oscillate_with_pulse_gains(self, pulse_frequency: torch.Tensor, pulse_gain_list,
                                   pulse_sync_gain_avg: bool = False, return_gain: bool = False,
                                   phase_offset: Optional[torch.Tensor] = None):
        """The oscillator's pulse (B, T12k) under pulse-synchronous gains, as
        the JAX package's `oscillate_with_pulse_gains`: each gain contour of
        `pulse_gain_list` ((B, T12k) or None) is held from each pulse start
        (or averaged over each pulse with `pulse_sync_gain_avg`) and applied
        to the pulse.  Returns a list of (B, T12k) signals (None entries pass
        through); with `return_gain`, ([pulse] per gain, [held gain or None]).
        The pulse and its phase come from one oscillator pass."""
        audio, phase = self._excite(pulse_frequency, phase_offset, return_phase=True)
        hold = gain_avg if pulse_sync_gain_avg else gain_hold
        audio_list, gain_list = [], []
        for pg in pulse_gain_list:
            if pg is None:
                (gain_list if return_gain else audio_list).append(None)
                continue
            full_gain = hold(phase, pg)
            if return_gain:
                audio_list.append(audio)
                gain_list.append(full_gain)
            else:
                audio_list.append(audio * full_gain)
        return (audio_list, gain_list) if return_gain else audio_list

    def fold_pulse_channels(self, pulse_signal: torch.Tensor, noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Fold the pulse-rate excitation ((B, T) or, with subharmonic
        channels, (B, T, 1 + n)) to the WaveNet input rate and append the
        sigma-scaled Gaussian noise channel.  The fold is a reshape to
        (B, T/pulse_channels, pulse_channels * (1 + n)), channels
        interleaved per sample as in the JAX package, or a PQMF analysis of
        the pulse to (B, T/subbands, subbands) followed by the subharmonic
        channels' reshape (`pulse_channels_use_pqmf`).  `noise` (B, T/fold,
        1) wins over `generator`; with neither, a generator seeded 0 is used,
        so every call draws the same noise, as the JAX package's PRNGKey(0)
        does."""
        B = pulse_signal.shape[0]
        n_sub = self.wavetable.add_subharm_chans
        if self.pulse_pqmf_analysis_filter is None:
            x = pulse_signal.reshape(B, -1, self.pulse_channels * (1 + n_sub))
        else:
            c = self.pulse_channels_multi_band_config
            pulse = pulse_signal if pulse_signal.dim() == 3 else pulse_signal[:, :, None]
            x = pqmf_analysis(pulse[:, :, :1], self.pulse_pqmf_analysis_filter, c["subbands"], c["taps"])
            if n_sub:
                x = torch.cat([x, pulse[:, :, 1:].reshape(B, -1, self.pulse_channels * n_sub)], dim=-1)
        if self.pp_mod_subnet_noise_channel_sigma:
            shape = x.shape[:-1] + (1,)
            if noise is None:
                noise = self.draw_noise(shape, x.dtype, x.device, generator)
            elif tuple(noise.shape) != tuple(shape):
                raise ValueError(f"noise shape {tuple(noise.shape)} != {tuple(shape)}")
            x = torch.cat((x, self.pp_mod_subnet_noise_channel_sigma * noise.to(x.device, x.dtype)), dim=-1)
        return x

    @staticmethod
    def draw_noise(shape, dtype: torch.dtype, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The noise channel's draw when no noise is given: N(0, 1) of `shape`
        from `generator`, or from a new generator on `device` seeded 0
        (`PaNWaveNet.noise` draws it for callers that hold the noise)."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    def generate_excitation(self, mel: torch.Tensor, pulse_frequency: torch.Tensor,
                            noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                            phase_offset: Optional[torch.Tensor] = None,
                            mb_gain: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Excitation waveform (B, T_mel*hop) at the output sample rate.
        `mb_gain` (B, >= T_sub, subbands), the multiband-gain branch's gains,
        multiplies the post net's subbands (sliced to their length, as in
        the JAX package)."""
        with span(MODEL_EXCITATION):
            x = self.fold_pulse_channels(self.oscillate(pulse_frequency, phase_offset), noise, generator)
        remat = self.remat_wavenet_blocks and self.differentiable and torch.is_grad_enabled()
        for name, block_span in zip(self.block_names, self.block_spans):
            block = getattr(self, name)
            with span(block_span):
                if remat:
                    # the backward pass runs the block's forward again instead of
                    # keeping its ~n_layers x (B, T, n_channels) activations (the
                    # JAX package's jax.checkpoint around each block)
                    x = checkpoint(block, x, mel, use_reentrant=False)
                else:
                    x = block(x, mel)
        with span(MODEL_POST_PQMF):
            post = self.wn_post_net
            if self.pqmf_synthesis_filter is None:
                x = post(x)
                if mb_gain is not None:
                    x = x * mb_gain[:, : x.shape[1]]
                return x.reshape(x.shape[0], x.shape[1] * x.shape[2])  # depth to time
            kernel, bias, gain = post.conv_args()
            fn = post_pqmf_plain if self.differentiable else post_pqmf
            return fn(x, kernel[:, :, 0], bias, gain, mb_gain, self.pqmf_synthesis_filter, self.mb_factor,
                      self.pqmf_synthesis_filter.shape[1])

    def get_cepstral_windows(self, f0: torch.Tensor, smooth_stride: int) -> torch.Tensor:
        """F0-adaptive cepstral window per frame: smooth F0, pick the nearest
        of the 30 log-spaced windows (a gather)."""
        kern = self.frequency_smoothing_kernel
        k = kern.shape[0]
        f0_padded = torch.cat((f0[:, :1].expand(-1, k // 2), f0, f0[:, -1:].expand(-1, k // 2)), dim=1)
        smoothed = F.conv1d(f0_padded[:, None, :], kern[None, None, :], stride=smooth_stride)[:, 0]
        log10f0 = self.ps_cepstral_windows_log10f0
        smooth_log10f0 = torch.clamp((1 / np.log(10)) * torch.log(smoothed), log10f0[0], log10f0[-1])
        ratio = (smooth_log10f0 - log10f0[0]) / (log10f0[-1] - log10f0[0])
        idx = torch.round(ratio * (log10f0.shape[0] - 1)).long()
        return self.ps_cepstral_windows[idx]

    def generate_specenv(self, mel: torch.Tensor, pulse_frequency: torch.Tensor, training: bool = False):
        """Cepstral spectral-envelope filter, complex (B, T_mel, fft//2+1); with
        `training`, (filter, aux losses), as the JAX package's
        `generate_specenv`.  The cepstrum is windowed by the F0-adaptive
        cepstral window (`ps_env_order_scale`), or, with
        `psns_use_cepstral_loss_constraint`, left unwindowed and held to the
        window by the aux loss "PS_cepstral_loss" in training.  Its gain
        coefficient is dropped (the source gain carries it) unless
        `spect_filters_preserve_energy`, which keeps it and divides the
        filter by its RMS over frequency (aux "PS_gain_loss" with
        `psns_gain_loss_weight`).  The log amplitude is tanh-bounded to
        `filter_max_db_range` when it is set."""
        x = self._run_subnet(self.ps_subnet, mel)
        aux = {}
        if self.ps_cepstral_windows is not None:
            windows = None
            if training or not self.psns_use_cepstral_loss_constraint:
                windows = self.get_cepstral_windows(pulse_frequency,
                                                    smooth_stride=self.spect_to_pulse_upsampling_factor)
            if not self.psns_use_cepstral_loss_constraint:
                x = x * windows
            elif training:
                aux["PS_cepstral_loss"] = torch.mean(torch.abs(x * (1 - windows)))
        if not self.spect_filters_preserve_energy:
            x = F.pad(x[:, :, 1:], (1, 0))
        log_amp_phase = rdft(x, self.fft_size)
        if self.filter_max_log_range:
            log_amp_phase = torch.complex(self.filter_max_log_range * torch.tanh(log_amp_phase.real),
                                          log_amp_phase.imag)
        source_filter = torch.exp(log_amp_phase)
        if self.spect_filters_preserve_energy:
            filter_gain = torch.sqrt(torch.mean(torch.abs(source_filter) ** 2, dim=-1, keepdim=True))
            source_filter = source_filter / filter_gain
            if self.psns_gain_loss_weight and training:
                aux["PS_gain_loss"] = torch.mean((filter_gain - 1 / (filter_gain + 0.001)) ** 2)
        return (source_filter, aux) if training else source_filter

    def generate_multiband_gain(self, mel: torch.Tensor, training: bool = False):
        """The multiband-gain branch (`ps_use_stft: false`): one gain per
        subband and frame, exp of the envelope subnet's output (B, T_mel,
        subbands), made zero-mean over the subbands first with
        `spect_filters_preserve_energy` (aux "PS_gain_loss" in training)."""
        x = self._run_subnet(self.ps_subnet, mel)
        aux = {}
        if self.spect_filters_preserve_energy:
            mean_gain = torch.mean(x, dim=-1, keepdim=True)
            x = x - mean_gain
            if self.psns_gain_loss_weight and training:
                aux["PS_gain_loss"] = torch.mean(torch.abs(mean_gain))
        return (torch.exp(x), aux) if training else torch.exp(x)

    # ----------------------------------------------------------------- call

    @exact_fp32()
    def forward(self, mel: torch.Tensor, F0: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, phase_offset: Optional[torch.Tensor] = None,
                return_PP: bool = False):
        """Full synthesis: (B, T_mel, mel_channels) -> (B, T_mel*hop) audio.
        A given F0 (B, T_mel*spect_to_pulse_ups) replaces the F0 net's, which
        is then not run unless `return_PP` asks for it.  With `return_PP`,
        (signal, PP): PP is [["F0", the F0 net's contour at the output rate
        (strided by F0_down_sampling_factor)], ["PSig", the excitation],
        ["PS", |envelope filter| (B, T_mel, fft//2+1)]], as the JAX package's
        `__call__` returns them.  Without the STFT envelope (`ps_use_stft:
        false` or `ps_off`) the signal is the excitation itself, scaled per
        subband by the multiband gains unless `ps_off`, and PP holds the F0
        only, as in the JAX package."""
        pulse_frequency = self.generate_f0(mel) if F0 is None or return_PP else None
        f0 = F0 if F0 is not None else pulse_frequency
        if self.ps_off or not self.ps_use_stft:
            mb_gain = None
            if not self.ps_off:
                with span(MODEL_ENVELOPE):
                    mb_gain = self.ps_gain_interpolator(self.generate_multiband_gain(mel))
            signal = self.generate_excitation(mel, f0, noise=noise, generator=generator, phase_offset=phase_offset,
                                              mb_gain=mb_gain)
            if not return_PP:
                return signal
            return signal, [["F0", pulse_frequency[:, :signal.shape[1]:self.F0_down_sampling_factor]]]
        excitation = self.generate_excitation(mel, f0, noise=noise, generator=generator, phase_offset=phase_offset)
        win, hop = self.stft_win_size, self.spect_hop_size
        with span(MODEL_ENVELOPE):
            padded = F.pad(excitation, (win // 2, win // 2 + hop + 1))
            source_stft = stft(padded, win, hop, self.fft_size, self.stft_window)[:, : mel.shape[1]]
            source_filter = self.generate_specenv(mel, f0)
            signal = istft(source_stft * source_filter, win, hop, self.fft_size, self.istft_window)
        n_pulse = mel.shape[1] * self.spect_to_pulse_upsampling_factor
        signal = signal[:, win // 2: win // 2 + n_pulse * self.F0_down_sampling_factor]
        if not return_PP:
            return signal
        n = signal.shape[1]
        return signal, [["F0", pulse_frequency[:, :n:self.F0_down_sampling_factor]],
                        ["PSig", excitation[:, :n]], ["PS", torch.abs(source_filter)]]

    def output_length(self, T_mel: int) -> int:
        return T_mel * self.spect_hop_size
