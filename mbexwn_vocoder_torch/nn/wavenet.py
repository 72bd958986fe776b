"""Dilated gated WaveNet stack with mel conditioning (SAME or CAUSAL).

Counterpart of the JAX package's nn/wavenet.py (`WaveNetAE`,
`WaveNetAEBlock`).  The start, pre-conditioning, conditioning, end and
up/down convs are plain `F.conv1d`.  The dilated gated stack takes one of
three routes (`WaveNetAE.route`), by the JAX package's own dispatch rule
(its nn/wavenet.py:259-284) widened to per-layer conditioning, not as a
fallback:

- "k1", the kernel: `ops.wavenet_stack.wavenet_stack`, the CUDA kernel on a
  CUDA tensor and its plain version on a CPU tensor.  It takes a stack only
  when all of these hold: one channel group, conditioning (shared by all
  layers through the sub-pixel + linear upsampling path, or per layer: the
  JAX package's layer loop takes those), kernel size 3, the gtu gate, no
  tensor-parallel axis and no int8 mode; SAME or CAUSAL taps alike.  This
  is the route of every registry model and of WaveGlow's WNs
  (models/waveglow.py).  A shared cond whose linear upsampling factor U is
  above 1 reaches it at the frame rate (`conditioning(frame_rate=True)`,
  the cond conv's output and its end pad) with U, and K1 interpolates each
  row's value on chip; every other route, and a per-layer cond, take the
  full-rate slab.  It has no backward pass (nor has the JAX
  package's Pallas stack): `stack_weights` raises when grad mode is on and
  a weight requires grad, and the kernel raises on CUDA tensors that
  require grad;
- "int8", the int8 mode (`MBEXWN_WN_QUANT=int8`, read at call time, as the
  JAX package reads it): every dilated and res/skip conv of a SAME, k=3
  stack is an int8 product (ops/quant.py); the start, end and cond convs
  stay in the compute dtype.  It takes the stack ahead of the kernel: the
  port has no batch-1 "auto" rule, and a user who sets the variable asks
  for int8.  A CAUSAL stack is not quantized, as in JAX.  Inference only;
- "layers", the layer loop (`_layers`): each dilated conv + cond, the gate,
  the res/skip 1x1 conv and its residual and skip halves, in the compute
  dtype (the skip sum too), per channel group.  Every stack that the
  kernel does not take runs it, on the CPU and on the card alike, and so
  does the differentiable route (`differentiable = True`, set by the
  trainer), as the JAX package's XLA route is the one its trainer
  differentiates.

Branches: `n_ch_groups` channel groups (the residual, the cond slab and
the skip sum split per group; layers `conv1D_{i}g{g}` / `res_skip_{i}g{g}`
for g > 0), per-layer conditioning (`cond_conv_upsampling=None`: one cond
conv of 2*C*n_layers channels, one slab a layer and group; a 1-wide one
without pre-cond convs is a product on the channels-last rows, so its
(B, T, L * 2C) output is the row-major slab K1 reads as it is),
`pre_cond_layer_channels` (`precond_{i}` convs before the cond conv),
`disable_conditioning`, any odd kernel size, the gtu/glu/gfu/gsu gates.

Tensor parallelism (`tp_axis="model"`, from `MBEXWN_TP_AXIS` when the model
is built): a stack placed on the devices of a mesh's "model" axis
(`parallel.tensor.shard_model`) splits its hidden channels over them, each
device holding its rows of every dilated conv and cond slab and the
matching input columns of every res/skip conv; per layer the partial
res/skip products are summed into the full residual and skip
(parallel/tensor.py).  A stack with `tp_axis` never takes the kernel, as in
JAX; unplaced, its layer loop runs on one device.  In the int8 mode a
placed stack splits its quantized layers the same way (each weight
quantized whole, then sharded; the res/skip input's per-sample abs-max
reduced across the shards).

Equalized LR without weight norm (`use_equalized_lr` and not
`use_weight_norm`, nn/layers.py) keeps a post-gain `g` beside each
unfolded kernel.  The layer loop applies it after each conv; the kernel's
packed weights, the int8 weights and the tensor-parallel shards take the
effective kernel g * weight (`Conv1DWeightNorm.kernel`), so every route
computes the layer loop's result.  (The JAX package's Pallas and int8
routes read the unfolded kernel and drop `g`.)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import Int8Weight, conv1x1_int8_prepared, dilated_conv1d_k3_int8_prepared, wn_quant_mode
from ..ops.wavenet_stack import PackedStackWeights, gate, pack_stack_weights, padded_channels, wavenet_stack
from .layers import Conv1DUpDownSample, Conv1DWeightNorm, LinInterpLayer

_PACKED = ("w_dil", "b_dil", "w_rs", "b_rs")
_INT8 = ("q", "scale", "bias")  # the fields of ops.quant.Int8Weight
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
TP_AXES = ("model",)  # the mesh axis a stack's hidden channels may be split over
WEIGHT_CACHES = ("_stack_cache", "_int8_cache", "_tp_cache", "_tp_int8_cache")


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


def int8_layer(x: torch.Tensor, cond: Optional[torch.Tensor], weights: Tuple[Int8Weight, Int8Weight],
               dilation: int, activation: str) -> torch.Tensor:
    """One gated layer in the int8 mode -> its res/skip output; each
    product's fp32 output is cast to x's dtype before the cond and the
    residual are added, as in JAX."""
    w_dil, w_rs = weights
    y = dilated_conv1d_k3_int8_prepared(x, w_dil, dilation).to(x.dtype)
    if cond is not None:
        y = y + cond
    return conv1x1_int8_prepared(gate(activation, *y.chunk(2, dim=-1)), w_rs).to(x.dtype)


class WaveNetAE(nn.Module):
    """start 1x1 -> n_layers dilated gated convs with residual+skip 1x1s ->
    end 1x1; mel conditioning either per layer (one big conv) or through an
    upsampling path shared by all layers."""

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
        tp_axis: Optional[str] = None,
        name: str = "wavenet",
    ):
        super().__init__()
        if activation not in ("gtu", "glu", "gfu", "gsu"):
            raise RuntimeError(f"WaveNetAE::error::unsupported wavenet activation {activation}")
        if n_out_channels is None:
            raise RuntimeError("WaveNetAE::error::n_out_channels parameter is required")
        if kernel_size % 2 != 1 or n_channels % 2:
            raise ValueError(f"WaveNetAE: kernel_size must be odd and n_channels even, got {kernel_size}, "
                             f"{n_channels}")
        if n_channels % n_ch_groups:
            raise RuntimeError(f"WaveNetAE::error::n_channels {n_channels} has to be a multiple of n_ch_groups "
                               f"{n_ch_groups}")
        if padding.upper() not in ("SAME", "CAUSAL"):
            raise ValueError(f"WaveNetAE: padding must be SAME or CAUSAL, got {padding}")
        if tp_axis is not None and tp_axis not in TP_AXES:
            raise ValueError(f"WaveNetAE: tp_axis must be one of {TP_AXES} or None, got {tp_axis!r}")
        self.name = name
        self.n_channels = n_channels
        self.n_layers = n_layers
        self.kernel_size = kernel_size
        self.n_ch_groups = n_ch_groups
        self.n_grp_channels = n_channels // n_ch_groups
        self.activation = activation
        self.padding = padding.upper()
        self.causal = self.padding == "CAUSAL"
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.tp_axis = tp_axis
        conv_kw = dict(use_weight_norm=use_weight_norm, use_equalized_lr=use_equalized_lr)

        self.start = Conv1DWeightNorm(in_channels, n_channels, 1, name="start", **conv_kw)
        self.n_pre_cond = 0
        self.cond = self.cond_linup = None
        self.shared_cond = not disable_conditioning and cond_conv_upsampling is not None
        if not disable_conditioning:
            c_in = cond_channels
            for i, ch in enumerate(pre_cond_layer_channels or []):
                self.add_module(f"precond_{i}", Conv1DWeightNorm(c_in, ch, cond_kernel_size, padding=padding,
                                                                 name=f"precond_{i}", **conv_kw))
                c_in = ch
            self.n_pre_cond = len(pre_cond_layer_channels or [])
            if cond_conv_upsampling is None:
                # one conv producing a distinct 2 * n_channels slab per layer
                self.cond = Conv1DWeightNorm(c_in, 2 * n_channels * n_layers, cond_kernel_size, padding=padding,
                                             name="cond", **conv_kw)
            else:
                # sub-pixel conv then linear interpolation: one slab shared by all layers
                self.cond = Conv1DUpDownSample(c_in, 2 * n_channels, kernel_size=cond_kernel_size,
                                               factor=cond_conv_upsampling, up_sample=True, padding=padding,
                                               use_checkerboard_free_init=True, name="cond", **conv_kw)
                self.cond_linup = LinInterpLayer(cond_lin_upsampling, num_pad_end=1, drop_last=True,
                                                 name="cond_linup")
        Cg = self.n_grp_channels
        self.dilations = []
        self.layer_names: List[Tuple[str, str]] = []  # (dilated conv, res/skip conv) at index * n_ch_groups + group
        for index in range(n_layers):
            if max_log2_dilation_rate is not None:
                dilation = 2 ** (int(index // dilation_rate_step) % max_log2_dilation_rate)
            else:
                dilation = 2 ** int(index // dilation_rate_step)
            self.dilations.append(dilation)
            for grp in range(n_ch_groups):
                sfx = f"{index}" + (f"g{grp}" if grp else "")
                self.add_module(f"conv1D_{sfx}", Conv1DWeightNorm(
                    Cg, 2 * Cg, kernel_size, dilation_rate=dilation, padding=padding, name=f"conv1D_{sfx}", **conv_kw))
                self.add_module(f"res_skip_{sfx}", Conv1DWeightNorm(
                    Cg, 2 * Cg if index < n_layers - 1 else Cg, 1, name=f"res_skip_{sfx}", **conv_kw))
                self.layer_names.append((f"conv1D_{sfx}", f"res_skip_{sfx}"))
        self.end = Conv1DWeightNorm(n_channels, n_out_channels, 1, name="end", **conv_kw)
        for attr in WEIGHT_CACHES:
            setattr(self, attr, None)
        self.frozen_dtype = self.frozen_route = None
        self.differentiable = False
        self.tp_devices: Optional[Tuple[torch.device, ...]] = None  # set by parallel.tensor.shard_model

    # ------------------------------------------------------------------ routes

    def route(self) -> str:
        """"k1", "int8" or "layers": the route the next forward pass takes, by
        the rule of the module docstring (a frozen stack's is the one it was
        frozen for)."""
        if self.differentiable:
            return "layers"
        if self.frozen_dtype is not None:
            return self.frozen_route
        if wn_quant_mode() == "int8" and self.kernel_size == 3 and not self.causal:
            return "int8"
        if (self.n_ch_groups == 1 and self.cond is not None and self.kernel_size == 3 and self.activation == "gtu"
                and self.tp_axis is None):
            return "k1"
        return "layers"

    # ---------------------------------------------------------------- weights

    def _pair(self, li: int) -> Tuple[Conv1DWeightNorm, Conv1DWeightNorm]:
        conv, rs = self.layer_names[li]
        return getattr(self, conv), getattr(self, rs)

    def _cached(self, attr: str, key, build):
        """`build()`, kept in `attr` until a parameter is replaced or changed
        in place (load_state_dict, .to()) or `key` changes, so a synthesis
        does not re-cast and re-lay out the weights.  While a graph is
        traced (torch.export) it is built from the traced parameters and not
        kept.  The weights built carry no gradient: with grad mode on and a
        weight that requires grad this raises."""
        params = list(self.parameters())
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            raise RuntimeError(
                f"{self.name}: the WaveNet stack's inference route has no backward pass and would drop the "
                f"gradients of its weights; run it under torch.no_grad()/torch.inference_mode(), or train "
                f"through the differentiable route (training.Trainer sets `differentiable`)")
        if torch.compiler.is_compiling():
            return build()
        key = (key, tuple((id(p), p._version) for p in params))
        cache = getattr(self, attr)
        if cache is None or cache[0] != key:
            # the params are held too, so their ids cannot be reused while cached
            cache = (key, build(), params)
            setattr(self, attr, cache)
        return cache[1]

    def stack_weights(self, dtype: torch.dtype) -> PackedStackWeights:
        """Per-layer (w_dil (2C, 3, Cp), b_dil, w_rs (Cout, Cp), b_rs) in `dtype`,
        the kernel layout of ops/wavenet_stack.py (reduction dimension padded
        with zeros to Cp), kept as `_cached` says.  A frozen stack
        (`freeze_stack_`) returns its buffers."""
        if self.frozen_dtype is not None:
            if dtype != self.frozen_dtype:
                raise ValueError(f"{self.name}: the stack is frozen in {self.frozen_dtype}, not {dtype}")
            return PackedStackWeights(*(getattr(self, f"packed_{k}") for k in _PACKED), self.frozen_skip_only,
                                      self.n_channels, padded_channels(self.n_channels))

        def build():
            out = []
            for li in range(self.n_layers):
                conv, rs = self._pair(li)
                out.append((conv.kernel().detach().permute(0, 2, 1).to(dtype), conv.bias.detach().to(dtype),
                            rs.kernel().detach()[:, :, 0].to(dtype), rs.bias.detach().to(dtype)))
            return pack_stack_weights(out)

        return self._cached("_stack_cache", dtype, build)

    def int8_weights(self, dtype: torch.dtype) -> List[Tuple[Int8Weight, Int8Weight]]:
        """Per layer and group, the dilated and the res/skip conv quantized
        (`ops.quant.Int8Weight`) from their weights in `dtype` (as the JAX
        package quantizes the params cast to the compute dtype), kept as
        `_cached` says."""
        if self.frozen_dtype is not None:
            if dtype != self.frozen_dtype:
                raise ValueError(f"{self.name}: the stack is frozen in {self.frozen_dtype}, not {dtype}")
            return [tuple(Int8Weight(*(getattr(self, f"int8_{li}_{conv}_{k}") for k in _INT8))
                          for conv in ("dil", "rs")) for li in range(len(self.layer_names))]

        def build():
            return [tuple(Int8Weight.of(c.kernel().detach().to(dtype), c.bias.detach().to(dtype))
                          for c in self._pair(li)) for li in range(len(self.layer_names))]

        return self._cached("_int8_cache", dtype, build)

    def freeze_stack_(self, dtype: torch.dtype) -> "WaveNetAE":
        """The serving form of an exported program, in place, for a stack on
        the kernel's route or the int8 route: the weights that route reads,
        made in `dtype`, become buffers (the kernel's packed layout
        `packed_w_dil`, ...; the int8 route's quantized weights, scales and
        fp32 biases `int8_{i}_{dil|rs}_{q|scale|bias}`) and the layers' own
        convs are dropped, so an exported graph reads them as they are
        instead of making them on every call.  The stack keeps that route;
        the others are gone with the convs."""
        route = self.route()
        if route == "layers":
            raise ValueError(f"{self.name}: a stack on the layer loop reads its convs; it cannot be frozen")
        with torch.no_grad():
            if route == "k1":
                packed = self.stack_weights(dtype)
                for k in _PACKED:
                    self.register_buffer(f"packed_{k}", getattr(packed, k))
                self.frozen_skip_only = packed.skip_only
            else:
                for li, pair in enumerate(self.int8_weights(dtype)):
                    for conv, w in zip(("dil", "rs"), pair):
                        for k in _INT8:
                            self.register_buffer(f"int8_{li}_{conv}_{k}", getattr(w, k))
        for conv, rs in self.layer_names:
            delattr(self, conv)
            delattr(self, rs)
        for attr in WEIGHT_CACHES:
            setattr(self, attr, None)
        self.frozen_dtype, self.frozen_route = dtype, route
        return self

    # ---------------------------------------------------------------- forward

    def cond_upsampling(self) -> int:
        """The factor U by which K1 upsamples the cond it is given: the
        shared cond's linear upsampling factor on the "k1" route, else 1."""
        if self.cond_linup is None or self.route() != "k1":
            return 1
        return self.cond_linup.upsampling_factor

    def conditioning(self, spect: torch.Tensor, frame_rate: bool = False) -> Optional[torch.Tensor]:
        """The cond slab(s): (B, T, 2C) shared, (B, T, 2C * n_layers) per
        layer, or None without conditioning; with `frame_rate`, a shared
        cond's frames before its linear upsampling (`LinInterpLayer.frames`:
        (B, T / U + 1, 2C))."""
        if self.cond is None:
            return None
        c = spect
        for i in range(self.n_pre_cond):
            c = getattr(self, f"precond_{i}")(c)
        if self.cond_linup is None and self.n_pre_cond == 0 and self.cond.kernel_size == 1:
            # a 1-wide per-layer cond conv as a product on the rows: row-major (B, T, L * 2C)
            bias = self.cond.bias
            return F.linear(c, self.cond.kernel()[:, :, 0].to(c.dtype), None if bias is None else bias.to(c.dtype))
        c = self.cond(c)
        if self.cond_linup is None:
            return c
        return self.cond_linup.frames(c) if frame_rate else self.cond_linup(c)

    def forward(self, audio: torch.Tensor, spect: torch.Tensor) -> torch.Tensor:
        in_dtype = audio.dtype
        if self.compute_dtype is not None:
            audio = audio.to(self.compute_dtype)
            spect = spect.to(self.compute_dtype)
        started = self.start(audio)
        route, U = self.route(), self.cond_upsampling()
        cond = self.conditioning(spect, frame_rate=U > 1)
        if cond is not None and (cond.shape[1] if U == 1 else (cond.shape[1] - 1) * U) != started.shape[1]:
            raise RuntimeError(f"conditioning length {cond.shape[1]} (upsampled by {U} in K1) != stack length "
                               f"{started.shape[1]}")
        if route == "k1":
            if not self.shared_cond:  # one slab a layer: K1 reads layer i's at column i * 2C of each row
                cond = cond.unflatten(-1, (self.n_layers, 2 * self.n_channels))
            skip = wavenet_stack(started, cond, self.stack_weights(started.dtype), self.dilations, self.activation,
                                 causal=self.causal, cond_upsampling=U).to(started.dtype)
        else:
            skip = self._layers(started, cond, quantized=route == "int8")
        return self.end(skip).to(in_dtype)

    def _layers(self, x: torch.Tensor, cond: Optional[torch.Tensor], quantized: bool = False) -> torch.Tensor:
        """The layer loop, in x's dtype, per channel group: each layer's
        res/skip output (from its convs, from `int8_layer` in the int8 mode,
        or from its shards on a model axis), its first half added to the
        group's residual (all but the last layer), the rest to the group's
        skip sum."""
        G, Cg, L = self.n_ch_groups, self.n_grp_channels, self.n_layers
        sharded = self.tp_devices is not None
        slabs = None if cond is None else cond.split(2 * Cg, dim=-1)  # G shared, or L * G per layer
        if sharded:
            from ..parallel import tensor

            weights = self._tp_int8_weights(x.dtype) if quantized else self._tp_weights(x.dtype)
            slabs = None if slabs is None else [tensor.scatter_rows(s, self.tp_devices) for s in slabs]
        elif quantized:
            weights = self.int8_weights(x.dtype)
        xs, out = list(x.split(Cg, dim=-1)), [None] * G
        for i in range(L):
            for g in range(G):
                li = i * G + g
                c = None if slabs is None else slabs[g if self.shared_cond else li]
                if sharded and quantized:
                    rs = tensor.sharded_int8_layer(xs[g], c, weights[li], self.tp_devices, self.activation,
                                                   self.dilations[i])
                elif sharded:
                    rs = tensor.sharded_layer(xs[g], c, weights[li], self.tp_devices, self.activation,
                                              self.dilations[i], self.padding)
                elif quantized:
                    rs = int8_layer(xs[g], c, weights[li], self.dilations[i], self.activation)
                else:
                    rs = self._layer(xs[g], c, li)
                if i < L - 1:
                    xs[g] = xs[g] + rs[..., :Cg]
                    rs = rs[..., Cg:]
                out[g] = rs if out[g] is None else out[g] + rs
        return torch.cat(out, dim=-1) if G > 1 else out[0]

    def _layer(self, x, cond, li):
        conv, rs = self._pair(li)
        y = conv(x)
        if cond is not None:
            y = y + cond
        return rs(gate(self.activation, *y.chunk(2, dim=-1)))

    def _tp_weights(self, dtype: torch.dtype):
        """Per layer and group, each model device's shard (parallel/tensor.py
        `shard_layer`) in `dtype`.  Without a gradient to keep they are kept
        as `_cached` says; on the differentiable route they are sliced from
        the parameters on every pass, so the gradients reach them."""
        from ..parallel import tensor

        def build():
            return [tensor.shard_layer(*self._pair(li), dtype, self.tp_devices)
                    for li in range(len(self.layer_names))]

        if self.differentiable and torch.is_grad_enabled():
            return build()
        return self._cached("_tp_cache", (dtype, self.tp_devices), build)

    def _tp_int8_weights(self, dtype: torch.dtype):
        """Per layer and group, each model device's shard of the int8 weights
        (`int8_weights`, quantized whole, then split by
        parallel/tensor.py `shard_int8_layer`), kept as `_cached` says."""
        from ..parallel import tensor

        def build():
            return [tensor.shard_int8_layer(w, self.tp_devices) for w in self.int8_weights(dtype)]

        return self._cached("_tp_int8_cache", (dtype, self.tp_devices), build)


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
