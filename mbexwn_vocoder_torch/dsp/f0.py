"""YIN F0 estimation (host-side NumPy): the contour the quality gate
compares and the training data's F0 target.  Copy of the JAX package's
dsp/f0.py: `estimate_f0`, cumulative-mean normalized difference over
autocorrelation (de Cheveigne & Kawahara 2002) with parabolic interpolation
and an aperiodicity-based voicing decision (F0 = 0 on unvoiced frames), and
`upsample_f0`, the frame-rate contour at the sample rate.
"""
from __future__ import annotations

import numpy as np


def estimate_f0(
    x: np.ndarray,
    sample_rate: float,
    hop: int,
    fmin: float = 50.0,
    fmax: float = 600.0,
    frame_len: int | None = None,
    threshold: float = 0.15,
) -> np.ndarray:
    """x: (T,) audio -> (T//hop + 1,) F0 in Hz (0 where unvoiced).

    Vectorized over frames: one rFFT cross-correlation batch instead of a
    per-frame np.correlate loop.
    """
    x = np.asarray(x, dtype=np.float64)
    tau_min = max(2, int(sample_rate / fmax))
    tau_max = int(sample_rate / fmin)
    if frame_len is None:
        frame_len = 2 * tau_max
    n_frames = x.shape[-1] // hop + 1
    L = frame_len + tau_max
    xp = np.pad(x, (frame_len // 2, L))

    frames = np.lib.stride_tricks.sliding_window_view(xp, L)[:: hop][:n_frames]  # (F, L)
    cumsq = np.concatenate([np.zeros((n_frames, 1)), np.cumsum(frames**2, axis=1)], axis=1)
    r0 = cumsq[:, frame_len]  # (F,)
    silent = r0 < 1e-8

    # difference function d(tau) = r0 + r_tau - 2*corr(tau) for all frames:
    # cross-correlation corr[k] = sum_j frame[k+j] * frame[j] via one rFFT batch
    nfft = 1 << int(np.ceil(np.log2(L)))
    F = np.fft.rfft(frames, nfft, axis=1)
    W = np.fft.rfft(frames[:, :frame_len], nfft, axis=1)
    corr = np.fft.irfft(F * np.conj(W), nfft, axis=1)[:, : tau_max + 1]
    taus = np.arange(tau_max + 1)
    r_tau = cumsq[:, taus + frame_len] - cumsq[:, taus]
    d = r0[:, None] + r_tau - 2 * corr

    # cumulative-mean normalisation
    dprime = np.ones((n_frames, tau_max + 1))
    csum = np.cumsum(d[:, 1:], axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        dprime[:, 1:] = d[:, 1:] * taus[1:] / np.where(csum > 0, csum, 1e-12)

    seg = dprime[:, tau_min:]
    below = seg < threshold
    any_below = below.any(axis=1)
    first_below = np.argmax(below, axis=1) + tau_min  # rows without a hit: garbage, masked later

    # walk from the first below-threshold lag to the next local minimum:
    # tau* = min{ t >= start : dprime[t+1] >= dprime[t] } (the scalar loop's
    # exit condition), with the walk allowed to end at tau_max
    inc = np.concatenate([dprime[:, 1:] >= dprime[:, :-1],
                          np.ones((n_frames, 1), dtype=bool)], axis=1)
    walk_mask = inc & (taus[None, :] >= first_below[:, None])
    tau_walk = np.argmax(walk_mask, axis=1)

    tau_min_idx = np.argmin(seg, axis=1) + tau_min
    aperiodic = ~any_below & (seg.min(axis=1) > 0.5)
    tau = np.where(any_below, tau_walk, tau_min_idx)

    # parabolic interpolation around the minimum (interior lags only)
    tau_c = np.clip(tau, 1, tau_max - 1)
    rows = np.arange(n_frames)
    a, b, c = dprime[rows, tau_c - 1], dprime[rows, tau_c], dprime[rows, tau_c + 1]
    denom = a - 2 * b + c
    with np.errstate(divide="ignore", invalid="ignore"):
        delta = np.where(np.abs(denom) > 1e-12, 0.5 * (a - c) / denom, 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    delta = np.where((tau >= 1) & (tau < tau_max), delta, 0.0)

    f0 = sample_rate / (tau + delta)
    f0 = np.where(silent | aperiodic, 0.0, f0)
    return f0.astype(np.float32)


def upsample_f0(f0_frames: np.ndarray, hop: int, total_len: int) -> np.ndarray:
    """Frame-rate F0 -> sample-rate contour by linear interpolation, keeping
    hard voiced/unvoiced edges (no interpolation across 0 boundaries)."""
    n = f0_frames.shape[-1]
    t_frames = np.arange(n) * hop
    t = np.arange(total_len)
    up = np.interp(t, t_frames, f0_frames)
    # zero out samples whose neighbouring frames disagree about voicing
    voiced = f0_frames > 0
    vo = np.interp(t, t_frames, voiced.astype(np.float64))
    up = np.where(vo >= 0.999, up, 0.0)
    return up.astype(np.float32)
