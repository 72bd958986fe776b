"""STFT / iSTFT with tf.signal-compatible framing and overlap-add.

The excitation -> spectral-envelope filter -> overlap-add resynthesis path
depends on the exact framing, windowing and OLA-normalisation conventions of
tf.signal.stft / inverse_stft / inverse_stft_window_fn; these are reproduced
sample-exactly (an off-by-one hop is audible as buzz).  The real DFTs are
`torch.fft.rfft` / `irfft`, the counterpart of the JAX package's "fft"
method.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def rdft(frames: torch.Tensor, fft_length: int) -> torch.Tensor:
    """rfft over the last axis with implicit zero-pad to fft_length."""
    return torch.fft.rfft(frames, n=fft_length, dim=-1)


def irdft(spec: torch.Tensor, fft_length: int, n_out: int) -> torch.Tensor:
    """First n_out samples of irfft(spec, fft_length) over the last axis."""
    return torch.fft.irfft(spec, n=fft_length, dim=-1)[..., :n_out]


def frame(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length); n_frames = 1 + (T-L)//S
    (tf.signal.frame with pad_end=False)."""
    return x.unfold(-1, frame_length, frame_step)


def stft(x: torch.Tensor, frame_length: int, frame_step: int, fft_length: int,
         window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tf.signal.stft(pad_end=False): frames start at 0, windowed frames are
    right-padded with zeros to fft_length before the rfft."""
    frames = frame(x, frame_length, frame_step)
    if window is not None:
        frames = frames * window
    return rdft(frames, fft_length)


def inverse_stft_window(frame_length: int, frame_step: int, forward_window: np.ndarray) -> np.ndarray:
    """tf.signal.inverse_stft_window_fn: forward window divided by the
    periodized sum of its squares over all frame_step shifts."""
    window = np.asarray(forward_window, dtype=np.float64)
    denom = window**2
    overlaps = -(-frame_length // frame_step)  # ceil
    denom = np.pad(denom, (0, overlaps * frame_step - frame_length))
    denom = denom.reshape(overlaps, frame_step).sum(axis=0)
    denom = np.tile(denom, overlaps)[:frame_length]
    return (window / denom).astype(np.float32)


def overlap_and_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
    """(..., F, L) -> (..., (F-1)*S + L) by overlap-add, as ceil(L/S)
    shifted adds over a (rows, S) grid (deterministic; no scatter)."""
    n_frames, L = frames.shape[-2], frames.shape[-1]
    S = frame_step
    m = -(-L // S)
    pad_cols = m * S - L
    if pad_cols:
        frames = torch.nn.functional.pad(frames, (0, pad_cols))
    blocks = frames.reshape(frames.shape[:-1] + (m, S))
    out_rows = n_frames - 1 + m
    acc = frames.new_zeros(frames.shape[:-2] + (out_rows, S))
    for j in range(m):
        acc[..., j : j + n_frames, :] += blocks[..., :, j, :]
    out = acc.reshape(acc.shape[:-2] + (out_rows * S,))
    return out[..., : (n_frames - 1) * S + L]


def istft(spec: torch.Tensor, frame_length: int, frame_step: int, fft_length: int,
          window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tf.signal.inverse_stft: irfft to fft_length, truncate to frame_length,
    multiply by `window` (typically inverse_stft_window), overlap-add."""
    frames = irdft(spec, fft_length, frame_length)
    if window is not None:
        frames = frames * window
    return overlap_and_add(frames, frame_step)
