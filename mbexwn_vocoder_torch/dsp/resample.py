"""Polyphase FIR resampling with a Kaiser-designed anti-aliasing low-pass,
and the Kaiser FIR sizing rule it shares with the wavetable pulse design.

Copy of the JAX package's dsp/resample.py (host side: the analysis front
end, the CLIs and wavetable initialisation).
"""
from __future__ import annotations

import math

import numpy as np
import scipy.signal as ss

# longest anti-aliasing filter we are willing to design before trading
# stop-band attenuation for length (one back-off step = -6 dB)
_MAX_AA_TAPS = 8000


def kaiser_beta_for_attenuation(stop_att: float) -> float:
    """Standard Kaiser-window beta for a given stop-band attenuation in dB."""
    if stop_att >= 50:
        return 0.1102 * (stop_att - 8.7)
    if stop_att >= 21:
        return 0.5842 * pow(stop_att - 21.0, 0.4) + 0.07886 * (stop_att - 21.0)
    return 0.0


def kaiser_fir_length(stop_att_db: float, trans_width_rad: float):
    """Kaiser FIR sizing: (half_length, beta, achieved_att_db).

    Applies the standard length estimate N ~ (A-8)/(2.285*dw) and, when the
    resulting filter would exceed the tap budget, trades attenuation for
    length in 6 dB steps (re-deriving beta each step).
    """
    att = stop_att_db
    while True:
        half_len = int(np.ceil((att - 8.0) / 2.285 / trans_width_rad / 2))
        if 2 * half_len > _MAX_AA_TAPS and att > 10:
            att -= 6
        else:
            break
    return half_len, kaiser_beta_for_attenuation(att), att


def resample(x, sr_in, sr_out, stop_att=70, axis=0, trans_width_normed=0.1, fir_filt=None):
    """Rational-rate resampling of x from sr_in to sr_out Hz.

    The anti-aliasing filter is designed on first use and returned so callers
    resampling many signals at the same rate pair can reuse it via fir_filt.
    Returns (resampled_signal, fir_filter).
    """
    sr_in = int(sr_in)
    sr_out = int(sr_out)
    common = math.gcd(sr_in, sr_out)
    up, down = sr_out // common, sr_in // common

    if fir_filt is None:
        # transition width in rad/sample at the lower of the two rates
        trans_width_rad = 2 * np.pi * min(1.0, sr_out / sr_in) * trans_width_normed
        half_len, beta, _ = kaiser_fir_length(stop_att, trans_width_rad)
        fir_filt = ss.firwin(
            (half_len * 2 + 1) * up,
            cutoff=(1 - trans_width_normed) / max(up, down),
            window=("kaiser", beta),
        ).astype(x.dtype if x.dtype == np.float32 else np.float64, copy=False)
    return ss.resample_poly(x, up, down, axis=axis, window=fir_filt), fir_filt
