"""Wavetable oscillator: drift-stable phase accumulation, then table lookup
and F0-grid cross-fade.

Counterpart of the JAX package's ops/oscillator.py (phase, lookup and
cross-fade) and ops/pallas_oscillator.py (the fused lookup + cross-fade).
`oscillate` is the entry point: F0 in, audio out.  On a CUDA tensor it runs
the whole stage (phase, lookup, cross-fade) in one launch of the CUDA kernel
`csrc/oscillator.cu`; on a CPU tensor it runs `oscillate_plain`, the same
function in plain PyTorch (chunked phase, then a 2-tap gather lerp in every
table and the tent cross-fade over the grid).

The stage is the `torch.library` custom op `mbexwn::oscillate` (the
grid's constants as float arguments; it always returns (audio, phase),
the phase empty unless asked for): its CUDA implementation launches the
kernel, its CPU implementation is the plain version, and a fake
implementation gives the shapes, so a traced or exported graph holds one
node per oscillator stage.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import kernel_lib

PHASE_CHUNK = 1000  # samples a phase chunk is cumsummed over (the kernel's kChunk)
_MAX_TABLE_BYTES = 232448 - 1024  # a block's shared memory on the H100, less the kernel's own


def phase_velocity(f0: torch.Tensor, sample_rate: float) -> torch.Tensor:
    """Phase increment per sample, F0 / sample rate, as a multiply by the fp32
    reciprocal: what jitted JAX and PyTorch's CUDA division compute."""
    return f0 * (1.0 / sample_rate)


def stable_cumsum_and_wrap(velocity: torch.Tensor, chunk_size: int = PHASE_CHUNK) -> torch.Tensor:
    """Accumulated phase mod 1 of shape (B, T), chunked to bound fp32 error:
    each chunk is cumsummed on its own and chunks are stitched with mod-1
    offsets that are themselves accumulated mod 1.

    Both cumsums accumulate in fp64 and round once to fp32.  For increments
    of F0 in 1 Hz - 12 kHz at 12 kHz every partial sum is exact in fp64, so
    the result is the same on every device and in any summation order (the
    CUDA kernel scans in parallel and matches it bit for bit)."""
    n_batch, n_time = velocity.shape
    remainder = n_time % chunk_size
    if remainder:
        velocity = torch.nn.functional.pad(velocity, (0, chunk_size - remainder))
    length = velocity.shape[1]
    chunks = velocity.reshape(n_batch, length // chunk_size, chunk_size)
    phase = torch.cumsum(chunks, dim=2, dtype=torch.float64).to(velocity.dtype)
    offsets = torch.remainder(phase[:, :, -1:], 1.0)
    offsets = torch.nn.functional.pad(offsets, (0, 0, 1, 0))[:, :-1]
    offsets = torch.remainder(torch.cumsum(offsets, dim=1, dtype=torch.float64).to(velocity.dtype), 1.0)
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


def oscillate_plain(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition, sample_rate,
                    phase_offset=None, return_phase=False):
    """`oscillate` in plain PyTorch."""
    phase = stable_cumsum_and_wrap(phase_velocity(f0, sample_rate))
    if phase_offset is not None:
        phase = torch.remainder(phase + phase_offset[:, None], 1.0)
    audio = oscillator_plain(phase, f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition)
    return (audio, phase) if return_phase else audio


def oscillate(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition, sample_rate,
              phase_offset=None, return_phase=False):
    """(B, T) fp32 F0 in Hz at `sample_rate`, (n_wavetable, n_grid) fp32
    tables -> (B, T) fp32 excitation, or (excitation, phase) with
    `return_phase`.  `phase_offset` (B,): the phase (mod 1) just before the
    first sample, the carry of chunked synthesis.  Calls the op
    `mbexwn::oscillate`: CUDA tensors launch the kernel once, CPU tensors
    take `oscillate_plain`.  The op has no backward pass: with grad mode
    on, inputs that require grad raise."""
    if f0.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"oscillate: unsupported device {f0.device}")
    audio, phase = torch.ops.mbexwn.oscillate(f0, wavetables, float(nominal_f0), float(grid_factor),
                                              float(min_transposition), float(max_transposition),
                                              float(sample_rate), phase_offset, bool(return_phase))
    return (audio, phase) if return_phase else audio


@torch.library.custom_op("mbexwn::oscillate", mutates_args=(), device_types="cpu")
def _oscillate_op(f0: torch.Tensor, wavetables: torch.Tensor, nominal_f0: float, grid_factor: float,
                  min_transposition: float, max_transposition: float, sample_rate: float,
                  phase_offset: Optional[torch.Tensor], return_phase: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version."""
    audio, phase = oscillate_plain(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition,
                                   sample_rate, phase_offset=phase_offset, return_phase=True)
    return audio, phase if return_phase else f0.new_empty(0)


@_oscillate_op.register_kernel("cuda")
def _oscillate_op_cuda(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition, sample_rate,
                       phase_offset, return_phase):
    """The op on CUDA tensors: the kernel, under the tensors' device."""
    with kernel_lib.on_device(f0.device):
        return _oscillate_cuda(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition,
                               sample_rate, phase_offset, return_phase)


@_oscillate_op.register_fake
def _(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition, sample_rate, phase_offset,
      return_phase):
    return torch.empty_like(f0), f0.new_empty(f0.shape if return_phase else (0,))


kernel_lib.no_backward(_oscillate_op, "oscillator")


def _oscillate_cuda(f0, wavetables, nominal_f0, grid_factor, min_transposition, max_transposition, sample_rate,
                    phase_offset, return_phase):
    """The op on CUDA tensors, under their device: (audio, phase or empty)."""
    for name, t in (("f0", f0), ("wavetables", wavetables), ("phase_offset", phase_offset)):
        if t is not None and (t.device != f0.device or t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"oscillate: {name} must be a contiguous float32 tensor on {f0.device}")
    if f0.dim() != 2 or wavetables.dim() != 2 or (phase_offset is not None and phase_offset.shape != f0.shape[:1]):
        raise ValueError(f"oscillate: shapes {tuple(f0.shape)}, {tuple(wavetables.shape)}"
                         f"{'' if phase_offset is None else ', ' + str(tuple(phase_offset.shape))} are not "
                         f"(B, T), (n_wavetable, n_grid), (B,)")
    n_wt, n_grid = wavetables.shape
    if n_wt < 2 or n_grid < 1 or n_wt * n_grid * 4 > _MAX_TABLE_BYTES:
        raise ValueError(f"oscillate: a {n_wt}x{n_grid} table does not fit in shared memory")
    if wavetables.data_ptr() % 16:
        raise ValueError("oscillate: the tables must start on a 16-byte boundary (the kernel bulk-copies them)")
    out = torch.empty_like(f0)
    phase = torch.empty_like(f0) if return_phase else f0.new_empty(0)
    B, T = f0.shape
    if f0.numel():
        scratch = torch.empty(B * -(-T // PHASE_CHUNK), dtype=torch.float32, device=f0.device)
        lib = kernel_lib.library()
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        err = lib.mbexwn_oscillate(f0.data_ptr(), wavetables.data_ptr(),
                                   None if phase_offset is None else phase_offset.data_ptr(), out.data_ptr(),
                                   phase.data_ptr() if return_phase else None, scratch.data_ptr(), B, T,
                                   PHASE_CHUNK, n_wt, n_grid, 1.0 / sample_rate, float(nominal_f0),
                                   float(min_transposition), float(max_transposition),
                                   float(1.0 / math.log(grid_factor)), stream)
        kernel_lib.check(err, "oscillator")
        kernel_lib.launches["oscillator"] += 1
    return out, phase
