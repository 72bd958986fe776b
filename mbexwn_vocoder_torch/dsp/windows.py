"""The periodic Hann window of the excitation-path STFT (init-time NumPy;
never on the hot path).  The JAX package's dsp/windows.py also holds the
analysis window family, which only mel analysis needs (ROADMAP.md queue 1,
item 9).
"""
from __future__ import annotations

import numpy as np


def hann_periodic(win_len: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, matching tf.signal.hann_window(periodic=True).

    Used by the excitation-path STFT (custom_pulsed_generator.py:388,692-694).
    """
    n = np.arange(win_len)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)).astype(dtype)
