"""Core layers: conv with folded weight norm, sub-pixel up/down conv,
linear-interp upsampler, padding, activations.

Counterpart of the JAX package's nn/layers.py.  A conv is in one of two
forms.  Folded (the default, for inference): it holds the folded kernel
(`g*v/||v||`, ops/conv.py) as its OIW `weight`, so a synthesis folds
nothing.  Trainable (`trainable_()`): it holds the JAX package's `v` (OIW),
`g` and `bias` as parameters and folds them in every forward pass, so the
gradients reach `v` and `g` as they do in the JAX trainer.  `fold_()` goes
back.  `init(generator)` draws the JAX package's initialisation (glorot
uniform or a scaled normal, the checkerboard-free averaging of sub-pixel
upsampling convs, `g = ||v||`) into either form.
Equalized LR without weight norm (`use_equalized_lr` and not
`use_weight_norm`) is the JAX package's post-gain form: the conv holds an
unfolded kernel (`weight`) and a per-channel gain `g` as parameters in both
forms and computes g * conv(x, weight) + bias; `kernel()` gives the
effective kernel g * weight, which is what the fused and quantized WaveNet
routes pack.
Every layer computes in its input's dtype and casts its parameters to it,
as the JAX package casts its params to the compute dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.conv import conv1d, equalized_lr_kernel, weight_norm_kernel
from ..ops.interp import linear_interp_output_length, linear_interp_upsample, pad_end
from ..ops.padding import pad1d


class Conv1DWeightNorm(nn.Module):
    """Conv1D over (B, T, Cin) with TF padding and weight norm (or its
    equalized-LR variant), folded (`weight`) or trainable (`v`, `g`)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int, strides: int = 1,
                 dilation_rate: int = 1, padding: str = "SAME", use_weight_norm: bool = True,
                 use_equalized_lr: bool = False, use_bias: bool = True, kernel_init_scale: Optional[float] = None,
                 no_cb_for_up_fac: int = 0, name: str = "conv"):
        super().__init__()
        self.name = name
        self.in_channels = in_channels
        self.filters = filters
        self.kernel_size = kernel_size
        self.strides = strides
        self.dilation_rate = dilation_rate
        self.padding = padding.upper()
        self.use_weight_norm = use_weight_norm
        self.use_equalized_lr = use_equalized_lr
        self.kernel_init_scale = kernel_init_scale
        self.no_cb_for_up_fac = no_cb_for_up_fac
        self.post_gain = use_equalized_lr and not use_weight_norm
        # glorot-uniform placeholder; real weights come from load_state_dict or init()
        limit = math.sqrt(6.0 / (kernel_size * (in_channels + filters)))
        self.weight = nn.Parameter(torch.empty(filters, in_channels, kernel_size).uniform_(-limit, limit))
        if self.post_gain:
            self.g = nn.Parameter(torch.ones(filters))
        self.bias = nn.Parameter(torch.zeros(filters)) if use_bias else None

    @property
    def trainable(self) -> bool:
        """True in the trainable form (`v`, `g`), False in the folded one."""
        return "v" in self._parameters

    def kernel(self) -> torch.Tensor:
        """The OIW kernel the conv applies (folded on the fly when trainable;
        the post-gain form's g * weight)."""
        if self.post_gain:
            return self.g[:, None, None] * self.weight
        if not self.trainable:
            return self.weight
        fold = equalized_lr_kernel if self.use_equalized_lr else weight_norm_kernel
        return fold(self.v, self.g)

    def conv_args(self) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(kernel (OIW), bias or None, post gain (Cout,) or None): what the
        conv applies, as `ops.conv.conv1d` takes it.  The post-gain form
        keeps g apart from its kernel, every other form folds it in."""
        if self.post_gain:
            return self.weight, self.bias, self.g
        return self.kernel(), self.bias, None

    def _set_form(self, kernel: torch.Tensor, trainable: bool, g: Optional[torch.Tensor] = None) -> None:
        """Hold `kernel` (OIW) in the folded form, or as (v, g) in the trainable
        one: v = kernel and g its per-channel norm (equalized LR: its rms) unless
        `g` is given, so that the fold gives `kernel` back."""
        for name in ("weight", "v", "g"):
            self._parameters.pop(name, None)
        self._buffers.pop("_equalized_lr", None)
        kernel = kernel.detach()
        if self.post_gain:
            self.weight = nn.Parameter(kernel.clone())
            self.g = nn.Parameter(torch.ones_like(kernel[:, 0, 0]) if g is None else g.detach().clone())
            return
        if not (trainable and self.use_weight_norm):
            self.weight = nn.Parameter(kernel.clone())
            return
        if g is None:
            sq = (kernel * kernel).mean(dim=(1, 2)) if self.use_equalized_lr else (kernel * kernel).sum(dim=(1, 2))
            g = torch.sqrt(sq)
        self.v = nn.Parameter(kernel.clone())
        self.g = nn.Parameter(g.detach().clone())
        if self.use_equalized_lr:
            # the JAX tree's `_equalized_lr` flag, so that a state_dict says which fold it needs
            self.register_buffer("_equalized_lr", torch.tensor(True))

    def trainable_(self) -> "Conv1DWeightNorm":
        """Folded -> trainable, in place (v = weight, g = its norm)."""
        if self.use_weight_norm and not self.trainable:
            self._set_form(self.weight, trainable=True)
        return self

    def fold_(self) -> "Conv1DWeightNorm":
        """Trainable -> folded, in place (weight = the fold of v and g)."""
        if self.trainable:
            with torch.no_grad():
                self._set_form(self.kernel(), trainable=False)
        return self

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX package's initialisation in the current form: a
        glorot-uniform kernel (or `kernel_init_scale` x normal), averaged over
        the sub-pixel phases when `no_cb_for_up_fac` is set, then g = ||v|| per
        channel (equalized LR, with or without weight norm: v = kernel / rms,
        g = rms); zero bias."""
        shape = (self.filters, self.in_channels, self.kernel_size)
        dev = self.bias.device if self.bias is not None else self.kernel().device
        if self.kernel_init_scale is not None:
            kernel = self.kernel_init_scale * torch.randn(shape, generator=generator)
        else:
            limit = math.sqrt(6.0 / (self.kernel_size * (self.in_channels + self.filters)))
            kernel = torch.empty(shape).uniform_(-limit, limit, generator=generator)
        if self.no_cb_for_up_fac:
            f = self.no_cb_for_up_fac
            phases = kernel.reshape(f, self.filters // f, self.in_channels, self.kernel_size)
            kernel = phases.mean(dim=0, keepdim=True).expand_as(phases).reshape(shape)
        g = None
        if self.use_equalized_lr:
            g_val = torch.sqrt(torch.mean(kernel * kernel))
            g = torch.full((self.filters,), float(g_val))
            kernel = kernel / g_val
        folded = not self.trainable
        self._set_form(kernel.to(dev), trainable=True, g=None if g is None else g.to(dev))
        if folded:
            self.fold_()
        if self.bias is not None:
            self.bias.zero_()

    def out_length(self, in_len: int) -> int:
        if self.padding in ("SAME", "CAUSAL"):
            return -(-in_len // self.strides)
        k_eff = (self.kernel_size - 1) * self.dilation_rate + 1
        return (in_len - k_eff) // self.strides + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias, gain = self.conv_args()
        return conv1d(x, kernel, bias, self.strides, self.dilation_rate, self.padding, gain)


class Conv1DUpDownSample(Conv1DWeightNorm):
    """Sub-pixel up/down-sampling conv (depth<->time reshape).

    up:   (B, T, Cin) -> conv to filters*factor -> (B, T*factor, filters)
    down: (B, T, Cin) -> conv to filters/factor -> (B, T/factor, filters)
    """

    def __init__(self, in_channels, filters, kernel_size=3, up_sample=None, factor=2,
                 use_checkerboard_free_init=False, name="convUD", **kwargs):
        if use_checkerboard_free_init and not up_sample:
            raise RuntimeError("use_checkerboard_free_init requires up_sample")
        self.up_sample = up_sample
        self.factor = factor
        self.out_filters = filters
        self.down_sample = (up_sample is not None) and (not up_sample)
        if self.down_sample and factor * (filters // factor) != filters:
            raise RuntimeError(f"filters {filters} is not a multiple of factor {factor}")
        internal = filters * factor if up_sample else (filters // factor if self.down_sample else filters)
        super().__init__(in_channels, internal, kernel_size, name=name,
                         no_cb_for_up_fac=factor if use_checkerboard_free_init else 0, **kwargs)

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

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """The frames `forward` interpolates between: x with its end pad."""
        return pad_end(x, self.num_pad_end)


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

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """The JAX package's initialisation: a PReLU's alpha at its constant."""
        if self.activation_function == "prelu":
            self.alpha.fill_(float(self.alpha_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.activation_function == "prelu":
            return torch.clamp(x, min=0.0) + self.alpha.to(x.dtype) * torch.clamp(x, max=0.0)
        if self.activation_function == "leaky_relu":
            return torch.nn.functional.leaky_relu(x, negative_slope=self.alpha_value)
        return _STATELESS_ACTIVATIONS[self.activation_function](x)


class PReLU(Activation):
    """PReLU with a per-channel alpha shared over time."""

    def __init__(self, alpha=0.2, channels: Optional[int] = None, name="prelu"):
        super().__init__("prelu", alpha=alpha, channels=channels, name=name)


class LeakyReLU(Activation):
    def __init__(self, alpha=0.2, name="lrelu"):
        super().__init__("leaky_relu", alpha=alpha, name=name)
