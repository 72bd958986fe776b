"""NumPy STFT analysis front end (host side): framing, STFT and its
least-squares inverse.  Copy of the JAX package's dsp/stft.py (frames
gathered in one shot, one batched rfft); the on-device STFT of the
synthesis path lives in ops/stft_ops.py.
"""
from __future__ import annotations

import numpy as np

from .windows import get_stft_window


def frame_signal(x: np.ndarray, win_len: int, hop_len: int, num_frames: int, axis: int = -1):
    """Gather overlapping frames of length win_len every hop_len samples."""
    x = np.moveaxis(x, axis, -1)
    idx = np.arange(num_frames)[:, None] * hop_len + np.arange(win_len)[None, :]
    frames = x[..., idx]  # (..., num_frames, win_len)
    return frames


def calc_stft(
    x,
    win_len,
    hop_len,
    fft_size,
    center=True,
    pad_mode="reflect",
    win_type="hann",
    axis=-1,
    do_mag=False,
    dtype=None,
    detrend_phase=False,
    norm_window=False,
):
    """STFT of x along `axis`.

    Semantics match the reference exactly (stft.py:14-96):
    - center=True pads win_len//2 at the left and a full win_len at the right,
      with num_frames = len//hop + 1
    - center=False requires len >= win_len, num_frames = (len-win_len)//hop + 1
    - do_mag returns magnitudes; detrend_phase multiplies by the linear-phase
      detrend vector exp(1j*pi*(win_len-1)*k/fft_size)
    """
    x = np.asarray(x)
    axis = int(np.arange(x.ndim)[axis])
    if dtype is None:
        dtype = x.dtype
    win = get_stft_window(win_type=win_type, win_len=win_len, dtype=dtype)
    if norm_window:
        win = win / np.sum(win)

    if center:
        num_frames = (x.shape[axis] // hop_len) + 1
        pad_spec = tuple(
            (0, 0) if ax != axis else (win_len // 2, win_len) for ax in range(x.ndim)
        )
        x = np.pad(x.astype(dtype, copy=False), pad_spec, mode=pad_mode)
    else:
        if x.shape[axis] < win_len:
            raise RuntimeError("calc_stft::error::cannot calculate STFT if signal is shorter than window")
        num_frames = ((x.shape[axis] - win_len) // hop_len) + 1
        x = x.astype(dtype, copy=False)

    frames = frame_signal(x, win_len, hop_len, num_frames, axis=axis)
    spec = np.fft.rfft(frames * win, fft_size, axis=-1)

    if detrend_phase and not do_mag:
        detrend_vec = np.exp(
            1j * np.pi * (win_len - 1) * np.arange(fft_size // 2 + 1) / fft_size
        )
        spec = spec * detrend_vec

    if do_mag:
        spec = np.abs(spec).astype(dtype)
    # reference inserts the frame axis at `axis`; with moveaxis semantics the
    # frame/freq axes are already the last two -- move them back
    if axis != x.ndim - 1:
        spec = np.moveaxis(spec, (-2, -1), (axis, axis + 1))
    return spec


def calc_istft(spec, win_len, hop_len, fft_size, length, win_type="hann",
               dtype=np.dtype("float32")):
    """Least-squares inverse of calc_stft(center=True): windowed overlap-add
    normalised by the window-square OLA sum.

    Exact for consistent spectra; for filtered spectra this is the standard
    LSE resynthesis.  The reference delegates this to an external STFT class
    (preprocess.py:16-25 `have_STFT` guard) that is not shipped; here it is
    native so the band-limit analysis path works out of the box.
    """
    spec = np.asarray(spec)
    win = get_stft_window(win_type=win_type, win_len=win_len, dtype=dtype)
    frames = np.fft.irfft(spec, fft_size, axis=-1)[..., :win_len].astype(dtype) * win
    n_frames = frames.shape[-2]
    total = (n_frames - 1) * hop_len + win_len
    out = np.zeros(frames.shape[:-2] + (total,), dtype)
    norm = np.zeros(total, dtype)
    wsq = win * win
    for i in range(n_frames):
        out[..., i * hop_len : i * hop_len + win_len] += frames[..., i, :]
        norm[i * hop_len : i * hop_len + win_len] += wsq
    out = out / np.fmax(norm, np.finfo(dtype).eps)
    start = win_len // 2
    return out[..., start : start + length]
