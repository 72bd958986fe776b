"""Linear-interpolation upsampler along the time axis.

(B, T, C) -> optionally pad `num_pad_end` copies of the last frame, then
linearly interpolate by `factor`: output length (T + P - 1)*U
+ (0 if drop_last else 1).
"""
from __future__ import annotations

import torch


def pad_end(x: torch.Tensor, num_pad_end: int) -> torch.Tensor:
    """(B, T, C) -> (B, T + num_pad_end, C): the last frame repeated."""
    if num_pad_end > 0:
        x = torch.cat([x, x[:, -1:].expand(-1, num_pad_end, -1)], dim=1)
    return x


def linear_interp_upsample(x: torch.Tensor, factor: int, num_pad_end: int = 0, drop_last: bool = False) -> torch.Tensor:
    x = pad_end(x, num_pad_end)
    B, T, C = x.shape
    if factor == 1:
        return x
    # out[t*U + j] = lerp(x[t], x[t+1], j/U)
    w1 = (torch.arange(factor, dtype=x.dtype, device=x.device) / factor)[None, None, :, None]
    w0 = 1.0 - w1
    y = x[:, :-1, None, :] * w0 + x[:, 1:, None, :] * w1  # (B, T-1, U, C)
    y = y.reshape(B, (T - 1) * factor, C)
    if not drop_last:
        y = torch.cat([y, x[:, -1:, :]], dim=1)
    return y


def linear_interp_output_length(in_len: int, factor: int, num_pad_end: int = 0, drop_last: bool = False) -> int:
    return (in_len + num_pad_end - 1) * factor + (0 if drop_last else 1)
