"""Kaiser FIR sizing rule shared by the wavetable pulse design.

Copy of the sizing half of the JAX package's dsp/resample.py (the
resampler itself is an analysis-side tool this package does not need yet).
"""
from __future__ import annotations

import numpy as np

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
