"""PQMF analysis and synthesis on tensors (the filters come from the numpy
dsp/pqmf.py, transposed to OIW).

Analysis (the pulse-channel PQMF fold, `pulse_channels_use_pqmf`): pad
taps//2 both sides and run one VALID conv with the analysis bank at stride
`subbands`.  Synthesis: zero-stuff each used band by `subbands` (scaled by
`subbands`), pad taps//2 both sides, and run one VALID conv with the
synthesis bank summing the bands.
"""
from __future__ import annotations

import torch

from .conv import conv1d


def pqmf_analysis(x: torch.Tensor, analysis_filter: torch.Tensor, subbands: int, taps: int) -> torch.Tensor:
    """(B, T, 1) -> (B, T/subbands, subbands); analysis_filter is OIW
    (subbands, 1, taps+1)."""
    x = torch.nn.functional.pad(x, (0, 0, taps // 2, taps // 2))
    return conv1d(x, analysis_filter, stride=subbands, padding="VALID")


def pqmf_synthesis(x: torch.Tensor, synthesis_filter: torch.Tensor, subbands: int, taps: int,
                   used_subbands=None) -> torch.Tensor:
    """(B, T, subbands) -> (B, T*subbands, 1); synthesis_filter is OIW
    (1, used_subbands, taps+1)."""
    used = used_subbands or subbands
    B, T, _ = x.shape
    x = x[:, :, :used]
    up = torch.cat([(x * subbands)[:, :, None, :], x.new_zeros((B, T, subbands - 1, used))], dim=2)
    up = up.reshape(B, T * subbands, used)
    up = torch.nn.functional.pad(up, (0, 0, taps // 2, taps // 2))
    return conv1d(up, synthesis_filter, padding="VALID")
