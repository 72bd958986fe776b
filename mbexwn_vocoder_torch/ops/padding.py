"""1-D time-axis padding with CONSTANT/REFLECT/SYMMETRIC/EDGE modes
(numpy's semantics, for pads no longer than the signal)."""
from __future__ import annotations

import torch


def pad1d(x: torch.Tensor, pad_left: int, pad_right: int, mode: str = "REFLECT") -> torch.Tensor:
    """Pad (B, T, C) along the time axis."""
    mode = mode.upper()
    T = x.shape[1]
    if mode not in ("CONSTANT", "REFLECT", "SYMMETRIC", "EDGE"):
        raise RuntimeError(f"pad1d::error:: padding mode {mode} is not supported")
    if max(pad_left, pad_right) > T - (mode == "REFLECT"):
        raise ValueError(f"pad1d: pads ({pad_left}, {pad_right}) exceed what {mode} can take from {T} frames")
    if mode == "CONSTANT":
        left = x.new_zeros((x.shape[0], pad_left, x.shape[2]))
        right = x.new_zeros((x.shape[0], pad_right, x.shape[2]))
    elif mode == "REFLECT":
        left = x[:, 1 : pad_left + 1].flip(1)
        right = x[:, T - 1 - pad_right : T - 1].flip(1)
    elif mode == "SYMMETRIC":
        left = x[:, :pad_left].flip(1)
        right = x[:, T - pad_right :].flip(1)
    else:
        left = x[:, :1].expand(-1, pad_left, -1)
        right = x[:, -1:].expand(-1, pad_right, -1)
    return torch.cat([left, x, right], dim=1)
