"""Slaney-style mel scale and mel filterbank, implemented from the published
Slaney Auditory-Toolbox formulas (no librosa dependency): the band centres
NormMelComponents needs and the filterbank of the mel analysis front end.
Copy of the JAX package's dsp/mel.py (librosa-compatible, htk=False,
norm='slaney').
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# Slaney mel scale constants: linear below 1 kHz (200/3 Hz per mel),
# logarithmic above with a factor of 6.4 per 27 mels.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies, htk: bool = False):
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    mels = frequencies / _F_SP
    if frequencies.ndim:
        log_t = frequencies >= _MIN_LOG_HZ
        mels[log_t] = _MIN_LOG_MEL + np.log(frequencies[log_t] / _MIN_LOG_HZ) / _LOGSTEP
    elif frequencies >= _MIN_LOG_HZ:
        mels = _MIN_LOG_MEL + np.log(frequencies / _MIN_LOG_HZ) / _LOGSTEP
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    freqs = _F_SP * mels
    if mels.ndim:
        log_t = mels >= _MIN_LOG_MEL
        freqs[log_t] = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels[log_t] - _MIN_LOG_MEL))
    elif mels >= _MIN_LOG_MEL:
        freqs = _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL))
    return freqs


def mel_frequencies(n_mels: int, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False):
    """Center frequencies of `n_mels` bands uniformly spaced on the mel scale."""
    min_mel = hz_to_mel(fmin, htk=htk)
    max_mel = hz_to_mel(fmax, htk=htk)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mel_to_hz(mels, htk=htk)


def _mel_basis(sr, n_fft, n_mels, fmin, fmax, htk=False, norm="slaney", dtype=np.float32):
    """Triangular mel filterbank (rows = mel bands, cols = FFT bins)."""
    if fmax is None:
        fmax = float(sr) / 2
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, float(sr) / 2.0, n_bins, endpoint=True)
    mel_f = mel_frequencies(n_mels + 2, fmin=fmin, fmax=fmax, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    lower = -ramps[:-2] / fdiff[:-1][:, np.newaxis]
    upper = ramps[2:] / fdiff[1:][:, np.newaxis]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        # area-normalize each triangle to constant energy per band
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, np.newaxis]
    elif norm is not None:
        raise ValueError(f"unsupported mel norm {norm}")

    return weights.astype(dtype)


@lru_cache(30, typed=True)
def mel_filter(sr, n_fft, n_mels, fmin, fmax, dtype=np.dtype("float32"), centered=False, norm=True):
    """Mel filterbank with the reference's `centered` variant.

    centered=True places the centers of the bordering bands on fmin/fmax
    instead of their edges (reference: preprocess.py:58-67).

    reference: MBExWN_NVoc/vocoder/model/preprocess.py:52-74
    """
    norm_arg = "slaney" if norm else None
    if centered:
        mel_freqs = mel_frequencies(n_mels=n_mels, fmin=fmin, fmax=fmax, htk=False)
        lower_half_band = mel_freqs[1] - mel_freqs[0]
        upper_half_band = mel_freqs[-1] - mel_freqs[-2]
        return _mel_basis(
            sr=sr,
            n_fft=n_fft,
            n_mels=n_mels,
            fmin=fmin - lower_half_band,
            fmax=fmax + upper_half_band,
            htk=False,
            norm=norm_arg,
            dtype=dtype,
        )
    return _mel_basis(
        sr=sr, n_fft=n_fft, n_mels=n_mels, fmin=fmin, fmax=fmax, htk=False, norm=norm_arg, dtype=dtype
    )


# alias mirroring the reference's public name
get_mel_filter = mel_filter
