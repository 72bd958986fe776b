"""Wavetable oscillator: drift-stable phase accumulation, then table lookup
and F0-grid cross-fade.

Counterpart of the JAX package's ops/oscillator.py (phase, lookup and
cross-fade) and ops/pallas_oscillator.py (the fused lookup + cross-fade).
`oscillator` is the entry point: on a CUDA tensor it launches the CUDA
kernel `csrc/oscillator.cu`; on a CPU tensor it runs `oscillator_plain`,
the same function in plain PyTorch (a 2-tap gather lerp in every table,
then the tent cross-fade over the grid).
"""
from __future__ import annotations

import math

import torch

from . import kernel_lib


def stable_cumsum_and_wrap(phase_velocity: torch.Tensor, chunk_size: int = 1000) -> torch.Tensor:
    """Accumulated phase mod 1 of shape (B, T), chunked to bound fp32 error:
    each chunk is cumsummed on its own and chunks are stitched with mod-1
    offsets that are themselves accumulated mod 1."""
    n_batch, n_time = phase_velocity.shape
    remainder = n_time % chunk_size
    if remainder:
        phase_velocity = torch.nn.functional.pad(phase_velocity, (0, chunk_size - remainder))
    length = phase_velocity.shape[1]
    chunks = phase_velocity.reshape(n_batch, length // chunk_size, chunk_size)
    phase = torch.cumsum(chunks, dim=2)
    offsets = torch.remainder(phase[:, :, -1:], 1.0)
    offsets = torch.nn.functional.pad(offsets, (0, 0, 1, 0))[:, :-1]
    offsets = torch.remainder(torch.cumsum(offsets, dim=1), 1.0)
    phase = torch.remainder(phase + offsets, 1.0).reshape(n_batch, length)
    return phase[:, :n_time]


def wavetable_lookup(phase: torch.Tensor, wavetables: torch.Tensor) -> torch.Tensor:
    """Linear-interp lookup of (B, T) phases in (n_wavetable, n_grid) tables
    -> (B, T, n_grid), each grid column sampled at the same phase."""
    n_period = wavetables.shape[0] - 1
    pw = phase * n_period
    j0 = torch.clamp(torch.floor(pw), 0, n_period - 1)
    frac = (pw - j0).unsqueeze(-1)
    j0 = j0.long()
    lo = wavetables[j0]
    hi = wavetables[j0 + 1]
    return lo * (1.0 - frac) + hi * frac


def grid_crossfade(audio_grid: torch.Tensor, frequency: torch.Tensor, nominal_f0: float, grid_factor: float,
                   min_transposition: float, max_transposition: float) -> torch.Tensor:
    """Cross-fade between adjacent grid tables with tent weights at
    log(clip(F0/nominal))/log(grid_factor)."""
    n_grid = audio_grid.shape[-1]
    log_ratio = torch.log(torch.clamp(frequency / nominal_f0, min_transposition, max_transposition))[..., None]
    diff = log_ratio * (1.0 / math.log(grid_factor)) - torch.arange(n_grid, dtype=audio_grid.dtype,
                                                                     device=audio_grid.device)
    weights = torch.clamp(1.0 - torch.abs(diff), min=0.0)
    return torch.sum(audio_grid * weights, dim=-1)


def oscillator_plain(phase, frequency, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition):
    """(B, T) phase and F0 -> (B, T) excitation, in plain PyTorch."""
    return grid_crossfade(wavetable_lookup(phase, wavetables), frequency, nominal_f0, grid_factor,
                          min_transposition, max_transposition)


def oscillator(phase, frequency, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition):
    """(B, T) fp32 phase in [0, 1) and F0 in Hz, (n_wavetable, n_grid) fp32
    tables -> (B, T) fp32 excitation.  CUDA tensors launch the kernel; CPU
    tensors take `oscillator_plain`."""
    if phase.device.type == "cpu":
        return oscillator_plain(phase, frequency, wavetables, nominal_f0, grid_factor,
                                min_transposition, max_transposition)
    if phase.device.type != "cuda":
        raise RuntimeError(f"oscillator: unsupported device {phase.device}")
    for name, t in (("phase", phase), ("frequency", frequency), ("wavetables", wavetables)):
        if t.device != phase.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"oscillator: {name} must be a contiguous float32 tensor on {phase.device}")
    if phase.dim() != 2 or frequency.shape != phase.shape or wavetables.dim() != 2:
        raise ValueError(f"oscillator: shapes {tuple(phase.shape)}, {tuple(frequency.shape)}, "
                         f"{tuple(wavetables.shape)} are not (B, T), (B, T), (n_wavetable, n_grid)")
    n_wt, n_grid = wavetables.shape
    if n_wt * n_grid * 4 > 227 * 1024:
        raise ValueError(f"oscillator: a {n_wt}x{n_grid} table does not fit in shared memory")
    out = torch.empty_like(phase)
    if phase.numel() == 0:
        return out
    lib = kernel_lib.library()
    stream = torch.cuda.current_stream(phase.device).cuda_stream
    err = lib.mbexwn_oscillator(phase.data_ptr(), frequency.data_ptr(), wavetables.data_ptr(), out.data_ptr(),
                                phase.numel(), n_wt, n_grid, float(nominal_f0), float(min_transposition),
                                float(max_transposition), float(1.0 / math.log(grid_factor)), stream)
    kernel_lib.check(err, "oscillator")
    kernel_lib.launches["oscillator"] += 1
    return out
