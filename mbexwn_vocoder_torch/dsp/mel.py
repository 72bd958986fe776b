"""Slaney-style mel scale, implemented from the published Slaney
Auditory-Toolbox formulas: the band centres NormMelComponents needs.  The
mel filterbank of the JAX package's dsp/mel.py waits for mel analysis
(ROADMAP.md queue 1, item 9).
"""
from __future__ import annotations

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
