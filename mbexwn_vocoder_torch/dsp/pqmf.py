"""PQMF (pseudo-QMF) cosine-modulated filterbank design.

Kaiser-window prototype (T.Q. Nguyen, "A Kaiser window approach for the design
of prototype filters of cosine modulated filterbanks", 1994) and the standard
cosine modulation for the analysis/synthesis banks.

Behavioural parity target: reference TFPQMF filter design
(reference: MBExWN_NVoc/vocoder/model/tf_preprocess.py:30-161).
Design is init-time NumPy; the on-device filtering lives in ops/pqmf_ops.py.
`design_prototype_filter_differentiable` is the prototype in torch, with
gradients to a tensor cutoff (the reference's trainable PQMF cutoff).
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



def design_prototype_filter_differentiable(cutoff_ratio, taps: int = 62, beta: float = 9.0):
    """`design_prototype_filter` in torch with a tensor `cutoff_ratio` (0-d),
    which gradients reach; the Kaiser window is fixed (it does not depend on
    the cutoff).  Returns the (taps+1,) prototype in the cutoff's dtype."""
    import torch

    assert taps % 2 == 0, f"taps must be even for a type-I linear-phase FIR, got {taps}"
    cutoff_ratio = torch.as_tensor(cutoff_ratio)
    dtype = cutoff_ratio.dtype if cutoff_ratio.is_floating_point() else torch.float32
    n = torch.arange(taps + 1, dtype=dtype, device=cutoff_ratio.device) - 0.5 * taps
    omega_c = np.pi * cutoff_ratio
    half = taps // 2
    left = torch.sin(omega_c * n[:half]) / (np.pi * n[:half])
    right = torch.sin(omega_c * n[half + 1:]) / (np.pi * n[half + 1:])
    h_i = torch.cat([left, cutoff_ratio.reshape(1).to(dtype), right])
    r = n / (0.5 * taps)
    w = torch.special.i0(beta * torch.sqrt(torch.clamp(1.0 - r * r, 0.0, 1.0)))
    w = w / torch.special.i0(torch.tensor(beta, dtype=dtype))
    return h_i * w
