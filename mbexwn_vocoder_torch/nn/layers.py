"""Core layers: conv with folded weight norm, sub-pixel up/down conv,
linear-interp upsampler, padding, activations.

Counterpart of the JAX package's nn/layers.py.  Inference only: each conv
holds the folded kernel (`g*v/||v||`, ops/conv.py) as its OIW `weight`.
Every layer computes in its input's dtype and casts its parameters to it,
as the JAX package casts its params to the compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.conv import conv1d
from ..ops.interp import linear_interp_output_length, linear_interp_upsample
from ..ops.padding import pad1d


class Conv1DWeightNorm(nn.Module):
    """Conv1D over (B, T, Cin) with TF padding; the weight-norm / equalized-LR
    decomposition is folded into `weight` when weights are loaded."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int, strides: int = 1,
                 dilation_rate: int = 1, padding: str = "SAME", use_weight_norm: bool = True,
                 use_equalized_lr: bool = False, use_bias: bool = True, name: str = "conv"):
        super().__init__()
        if use_equalized_lr and not use_weight_norm:
            # the unfolded post-gain form; no registry model uses it
            raise NotImplementedError(
                "equalized LR without weight norm is not ported (ROADMAP.md queue 1, item 13)")
        self.name = name
        self.in_channels = in_channels
        self.filters = filters
        self.kernel_size = kernel_size
        self.strides = strides
        self.dilation_rate = dilation_rate
        self.padding = padding.upper()
        if self.padding == "CAUSAL":
            raise NotImplementedError("CAUSAL stacks are not ported (ROADMAP.md queue 1, item 10)")
        # glorot-uniform placeholder; real weights come from load_state_dict
        limit = math.sqrt(6.0 / (kernel_size * (in_channels + filters)))
        self.weight = nn.Parameter(torch.empty(filters, in_channels, kernel_size).uniform_(-limit, limit))
        self.bias = nn.Parameter(torch.zeros(filters)) if use_bias else None

    def out_length(self, in_len: int) -> int:
        if self.padding == "SAME":
            return -(-in_len // self.strides)
        k_eff = (self.kernel_size - 1) * self.dilation_rate + 1
        return (in_len - k_eff) // self.strides + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight, self.bias, self.strides, self.dilation_rate, self.padding)


class Conv1DUpDownSample(Conv1DWeightNorm):
    """Sub-pixel up/down-sampling conv (depth<->time reshape).

    up:   (B, T, Cin) -> conv to filters*factor -> (B, T*factor, filters)
    down: (B, T, Cin) -> conv to filters/factor -> (B, T/factor, filters)
    """

    def __init__(self, in_channels, filters, kernel_size=3, up_sample=None, factor=2,
                 name="convUD", **kwargs):
        self.up_sample = up_sample
        self.factor = factor
        self.out_filters = filters
        self.down_sample = (up_sample is not None) and (not up_sample)
        if self.down_sample and factor * (filters // factor) != filters:
            raise RuntimeError(f"filters {filters} is not a multiple of factor {factor}")
        internal = filters * factor if up_sample else (filters // factor if self.down_sample else filters)
        super().__init__(in_channels, internal, kernel_size, name=name, **kwargs)

    def out_length(self, in_len: int) -> int:
        t = super().out_length(in_len)
        if self.up_sample:
            return t * self.factor
        if self.down_sample:
            return t // self.factor
        return t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        B, T, C = y.shape
        if self.up_sample:
            return y.reshape(B, T * self.factor, C // self.factor)
        if self.down_sample:
            return y.reshape(B, T // self.factor, C * self.factor)
        return y


class LinInterpLayer(nn.Module):
    """Fixed linear-interpolation upsampler (no parameters)."""

    def __init__(self, upsampling_factor, num_pad_end=0, drop_last=False, name="lininterp"):
        super().__init__()
        self.name = name
        self.upsampling_factor = upsampling_factor
        self.num_pad_end = num_pad_end
        self.drop_last = drop_last

    def out_length(self, in_len: int) -> int:
        return linear_interp_output_length(in_len, self.upsampling_factor, self.num_pad_end, self.drop_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_interp_upsample(x, self.upsampling_factor, self.num_pad_end, self.drop_last)


class Pad1d(nn.Module):
    def __init__(self, padding_size, padding_type="REFLECT", name="pad"):
        super().__init__()
        self.name = name
        try:
            self.padding_size = (padding_size[0], padding_size[1])
        except (IndexError, TypeError):
            self.padding_size = (padding_size, padding_size)
        self.padding_type = padding_type.upper()

    def out_length(self, in_len: int) -> int:
        return in_len + self.padding_size[0] + self.padding_size[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pad1d(x, self.padding_size[0], self.padding_size[1], self.padding_type)


def soft_sigmoid(x):
    """x -> 0.5 + 0.5*x/(1+|x|)"""
    return 0.5 + 0.5 * x / (1.0 + torch.abs(x))


def soft_sqrt(x):
    """x -> x/(1+sqrt(|x|))"""
    return x / (1.0 + torch.sqrt(torch.abs(x)))


_STATELESS_ACTIVATIONS = {
    "linear": lambda x: x,
    None: lambda x: x,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "soft_sign": torch.nn.functional.softsign,
    "elu": torch.nn.functional.elu,
    "selu": torch.nn.functional.selu,
    "soft_sigmoid": soft_sigmoid,
    "soft_sqrt": soft_sqrt,
    "exp": torch.exp,
    "relu": torch.relu,
}


class Activation(nn.Module):
    """Named activation; "prelu" holds a per-channel `alpha` shared over time."""

    def __init__(self, activation_function=None, alpha=0.2, channels: Optional[int] = None, name="act"):
        super().__init__()
        self.name = name
        self.activation_function = activation_function.lower() if activation_function else activation_function
        self.alpha_value = alpha
        if self.activation_function == "prelu":
            if channels is None:
                raise ValueError("prelu needs its channel count")
            self.alpha = nn.Parameter(torch.full((channels,), float(alpha)))
        elif self.activation_function != "leaky_relu" and self.activation_function not in _STATELESS_ACTIVATIONS:
            raise RuntimeError(f"Activation::error::unknown activation {activation_function}")

    def out_length(self, in_len: int) -> int:
        return in_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation_function == "prelu":
            return torch.clamp(x, min=0.0) + self.alpha.to(x.dtype) * torch.clamp(x, max=0.0)
        if self.activation_function == "leaky_relu":
            return torch.nn.functional.leaky_relu(x, negative_slope=self.alpha_value)
        return _STATELESS_ACTIVATIONS[self.activation_function](x)
