"""PQMF (pseudo-QMF) cosine-modulated filterbank design.

Kaiser-window prototype (T.Q. Nguyen, "A Kaiser window approach for the design
of prototype filters of cosine modulated filterbanks", 1994) and the standard
cosine modulation for the analysis/synthesis banks.

Behavioural parity target: reference TFPQMF filter design
(reference: MBExWN_NVoc/vocoder/model/tf_preprocess.py:30-161).
Design is init-time NumPy; the on-device filtering lives in ops/pqmf_ops.py.
"""
from __future__ import annotations

import numpy as np
import scipy.signal as ss


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass prototype, length taps+1."""
    assert taps % 2 == 0, f"taps must be even for a type-I linear-phase FIR, got {taps}"
    assert 0.0 < cutoff_ratio < 1.0, f"cutoff_ratio out of (0, 1): {cutoff_ratio}"

    omega_c = np.pi * cutoff_ratio
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * (np.arange(taps + 1) - 0.5 * taps)) / (
            np.pi * (np.arange(taps + 1) - 0.5 * taps)
        )
    h_i[taps // 2] = np.cos(0) * cutoff_ratio  # sinc limit at the center tap

    w = ss.windows.kaiser(taps + 1, beta)
    return h_i * w


def pqmf_filters(subbands: int, taps: int, cutoff_ratio: float, beta: float, max_band=None):
    """Cosine-modulated analysis/synthesis banks.

    Returns (analysis, synthesis) with shapes
      analysis:  (taps+1, 1, subbands)        -- conv kernel, WIO layout
      synthesis: (taps+1, used_subbands, 1)   -- conv kernel, WIO layout
    where used_subbands = max_band or subbands (partial-band synthesis,
    reference: tf_preprocess.py:115-117).
    """
    used_subbands = max_band if max_band else subbands

    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1) - taps / 2
    h_analysis = np.zeros((subbands, taps + 1))
    h_synthesis = np.zeros((used_subbands, taps + 1))
    for k in range(subbands):
        phase = (2 * k + 1) * (np.pi / (2 * subbands)) * n
        h_analysis[k] = 2 * h_proto * np.cos(phase + (-1) ** k * np.pi / 4)
        if k < used_subbands:
            h_synthesis[k] = 2 * h_proto * np.cos(phase - (-1) ** k * np.pi / 4)

    analysis = np.transpose(h_analysis[:, np.newaxis, :], (2, 1, 0)).astype(np.float32)
    synthesis = np.transpose(h_synthesis[np.newaxis, :, :], (2, 1, 0)).astype(np.float32)
    return analysis, synthesis

