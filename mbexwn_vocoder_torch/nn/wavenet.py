"""Dilated gated WaveNet stack with mel conditioning (SAME or CAUSAL).

Counterpart of the JAX package's nn/wavenet.py (`WaveNetAE`,
`WaveNetAEBlock`).  The start, conditioning, end and up/down convs are plain
`F.conv1d`.  The 12-layer dilated gated stack takes one of two routes:

- the inference route (the default): `ops.wavenet_stack.wavenet_stack`,
  which launches the CUDA kernel on a CUDA tensor and runs the plain
  version on a CPU tensor.  Neither has a backward pass (nor has the JAX
  package's Pallas stack), so this route refuses to run where a gradient
  is asked for: `stack_weights` raises when grad mode is on and a weight
  requires grad, and the kernel raises on CUDA tensors that require grad;
- the differentiable route (`differentiable = True`, set by the trainer):
  layer by layer through the convs' own `F.conv1d`, as the JAX package's
  XLA route, which is the one its trainer differentiates.  Operands are
  cast to the compute dtype as there (the skip sum too).

Scope is the registry's configuration: one channel group, conditioning
shared by all layers through the sub-pixel + linear upsampling path, kernel
size 3, SAME or CAUSAL padding (a CAUSAL stack's taps read t-2d, t-d and t;
the kernel takes either).  The other branches raise NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.wavenet_stack import PackedStackWeights, gate, pack_stack_weights, padded_channels, wavenet_stack
from .layers import Conv1DUpDownSample, Conv1DWeightNorm, LinInterpLayer

_PACKED = ("w_dil", "b_dil", "w_rs", "b_rs")
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def resolve_dtype(name) -> Optional[torch.dtype]:
    """Config/env dtype spelling -> torch dtype (None and "" mean fp32)."""
    if not name:
        return None
    if isinstance(name, torch.dtype):
        return name
    key = getattr(name, "__name__", str(name)).split(".")[-1]
    if key not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return _DTYPES[key]


class WaveNetAE(nn.Module):
    """start 1x1 -> n_layers dilated gated convs with residual+skip 1x1s ->
    end 1x1, conditioned by one upsampled mel slab shared by all layers."""

    def __init__(
        self,
        in_channels: int,
        cond_channels: int,
        n_channels: int = 256,
        n_layers: int = 12,
        kernel_size: int = 3,
        n_out_channels: Optional[int] = None,
        n_ch_groups: int = 1,
        dilation_rate_step: int = 1,
        max_log2_dilation_rate: Optional[int] = None,
        use_weight_norm: bool = True,
        use_equalized_lr: bool = False,
        activation: str = "gtu",
        padding: str = "SAME",
        disable_conditioning: bool = False,
        cond_kernel_size: int = 1,
        pre_cond_layer_channels=None,
        cond_conv_upsampling: Optional[int] = None,
        cond_lin_upsampling: int = 1,
        compute_dtype=None,
        name: str = "wavenet",
    ):
        super().__init__()
        if activation not in ("gtu", "glu", "gfu", "gsu"):
            raise RuntimeError(f"WaveNetAE::error::unsupported wavenet activation {activation}")
        if n_out_channels is None:
            raise RuntimeError("WaveNetAE::error::n_out_channels parameter is required")
        if n_ch_groups != 1:
            raise NotImplementedError("n_ch_groups > 1 is not ported (ROADMAP.md queue 1, item 13)")
        if disable_conditioning or cond_conv_upsampling is None or pre_cond_layer_channels:
            raise NotImplementedError("only the shared upsampled conditioning path is ported; per-layer "
                                      "conditioning waits (ROADMAP.md queue 1, item 13)")
        if padding.upper() not in ("SAME", "CAUSAL"):
            raise ValueError(f"WaveNetAE: padding must be SAME or CAUSAL, got {padding}")
        if kernel_size != 3:
            raise NotImplementedError("the WaveNet stack is ported for kernel size 3 only (ROADMAP.md queue 1, item 13)")
        self.name = name
        self.n_channels = n_channels
        self.n_layers = n_layers
        self.activation = activation
        self.causal = padding.upper() == "CAUSAL"
        self.compute_dtype = resolve_dtype(compute_dtype)
        conv_kw = dict(use_weight_norm=use_weight_norm, use_equalized_lr=use_equalized_lr)

        self.start = Conv1DWeightNorm(in_channels, n_channels, 1, name="start", **conv_kw)
        self.cond = Conv1DUpDownSample(cond_channels, 2 * n_channels, kernel_size=cond_kernel_size,
                                       factor=cond_conv_upsampling, up_sample=True, padding=padding,
                                       use_checkerboard_free_init=True, name="cond", **conv_kw)
        self.cond_linup = LinInterpLayer(cond_lin_upsampling, num_pad_end=1, drop_last=True, name="cond_linup")
        self.dilations = []
        for index in range(n_layers):
            if max_log2_dilation_rate is not None:
                dilation = 2 ** (int(index // dilation_rate_step) % max_log2_dilation_rate)
            else:
                dilation = 2 ** int(index // dilation_rate_step)
            self.dilations.append(dilation)
            self.add_module(f"conv1D_{index}", Conv1DWeightNorm(
                n_channels, 2 * n_channels, kernel_size, dilation_rate=dilation, padding=padding,
                name=f"conv1D_{index}", **conv_kw))
            res_skip_ch = 2 * n_channels if index < n_layers - 1 else n_channels
            self.add_module(f"res_skip_{index}", Conv1DWeightNorm(
                n_channels, res_skip_ch, 1, name=f"res_skip_{index}", **conv_kw))
        self.end = Conv1DWeightNorm(n_channels, n_out_channels, 1, name="end", **conv_kw)
        self._stack_cache = None
        self.frozen_dtype = None
        self.differentiable = False

    def stack_weights(self, dtype: torch.dtype) -> PackedStackWeights:
        """Per-layer (w_dil (2C, 3, Cp), b_dil, w_rs (Cout, Cp), b_rs) in `dtype`,
        the kernel layout of ops/wavenet_stack.py (reduction dimension padded
        with zeros to Cp).  Built once and kept until a parameter is replaced
        or changed in place (load_state_dict, .to()), so a synthesis does not
        re-cast and re-lay out 20 MB of weights.  While a graph is traced
        (torch.export) they are built from the traced parameters and not
        kept.  A frozen stack (`freeze_stack_`) returns its buffers.
        The packed weights carry no gradient: with grad mode on and a weight
        that requires grad this raises (the differentiable route is the
        trainer's, `differentiable = True`)."""
        if self.frozen_dtype is not None:
            if dtype != self.frozen_dtype:
                raise ValueError(f"{self.name}: the stack is frozen in {self.frozen_dtype}, not {dtype}")
            return PackedStackWeights(*(getattr(self, f"packed_{k}") for k in _PACKED), self.frozen_skip_only,
                                      self.n_channels, padded_channels(self.n_channels))
        params = list(self.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            raise RuntimeError(
                f"{self.name}: the WaveNet stack's inference route has no backward pass and would drop the "
                f"gradients of its weights; run it under torch.no_grad()/torch.inference_mode(), or train "
                f"through the differentiable route (training.Trainer sets `differentiable`)")
        tracing = torch.compiler.is_compiling()
        key = (dtype, tuple((id(p), p._version) for p in params))
        if tracing or self._stack_cache is None or self._stack_cache[0] != key:
            out = []
            for i in range(self.n_layers):
                conv = getattr(self, f"conv1D_{i}")
                rs = getattr(self, f"res_skip_{i}")
                out.append((conv.kernel().detach().permute(0, 2, 1).to(dtype), conv.bias.detach().to(dtype),
                            rs.kernel().detach()[:, :, 0].to(dtype), rs.bias.detach().to(dtype)))
            packed = pack_stack_weights(out)
            if tracing:
                return packed
            # the params are held too, so their ids cannot be reused while cached
            self._stack_cache = (key, packed, params)
        return self._stack_cache[1]

    def freeze_stack_(self, dtype: torch.dtype) -> "WaveNetAE":
        """The serving form of an exported program, in place: the stack's
        weights packed in `dtype` become buffers (`packed_w_dil`, ...) and
        the layers' own convs are dropped, so an exported graph reads the
        packed weights as they are instead of re-laying them out on every
        call.  The differentiable route is gone with the convs."""
        with torch.no_grad():
            packed = self.stack_weights(dtype)
        for k in _PACKED:
            self.register_buffer(f"packed_{k}", getattr(packed, k))
        for i in range(self.n_layers):
            delattr(self, f"conv1D_{i}")
            delattr(self, f"res_skip_{i}")
        self._stack_cache = None
        self.frozen_skip_only = packed.skip_only
        self.frozen_dtype = dtype
        return self

    def forward(self, audio: torch.Tensor, spect: torch.Tensor) -> torch.Tensor:
        in_dtype = audio.dtype
        if self.compute_dtype is not None:
            audio = audio.to(self.compute_dtype)
            spect = spect.to(self.compute_dtype)
        started = self.start(audio)
        cond = self.cond_linup(self.cond(spect))
        if cond.shape[1] != started.shape[1]:
            raise RuntimeError(f"conditioning length {cond.shape[1]} != stack length {started.shape[1]}")
        if self.differentiable:
            skip = self._layers(started, cond)
        else:
            skip = wavenet_stack(started, cond, self.stack_weights(started.dtype), self.dilations, self.activation,
                                 causal=self.causal).to(started.dtype)
        return self.end(skip).to(in_dtype)

    def _layers(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The differentiable route: each dilated conv + cond, the gate, the
        res/skip 1x1 conv and its residual and skip halves, in x's dtype."""
        C, out = self.n_channels, None
        for i in range(self.n_layers):
            y = getattr(self, f"conv1D_{i}")(x) + cond
            rs = getattr(self, f"res_skip_{i}")(gate(self.activation, y[..., :C], y[..., C:]))
            if i < self.n_layers - 1:
                x = x + rs[..., :C]
                rs = rs[..., C:]
            out = rs if out is None else out + rs
        return out


class WaveNetAEBlock(nn.Module):
    """WaveNetAE followed by an optional sub-pixel up/down-sampling conv
    (which runs in the block's input dtype, outside the compute dtype)."""

    def __init__(self, in_channels, cond_channels, n_out_channels, up_sample=None, up_down_factor=1,
                 padding="SAME", use_weight_norm=True, name="wnblock", **wavenet_kw):
        super().__init__()
        self.name = name
        self.wavenet = WaveNetAE(in_channels, cond_channels, n_out_channels=n_out_channels, padding=padding,
                                 use_weight_norm=use_weight_norm, name=name + "_WN", **wavenet_kw)
        self.up_down = None
        if up_sample is not None:
            self.up_down = Conv1DUpDownSample(n_out_channels, n_out_channels, kernel_size=3, padding=padding,
                                              up_sample=up_sample, factor=up_down_factor,
                                              use_weight_norm=use_weight_norm, name=name + "_UP")

    def out_length(self, in_len: int) -> int:
        return self.up_down.out_length(in_len) if self.up_down is not None else in_len

    def forward(self, audio: torch.Tensor, spect: torch.Tensor) -> torch.Tensor:
        y = self.wavenet(audio, spect)
        if self.up_down is not None:
            y = self.up_down(y)
        return y
