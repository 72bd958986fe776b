"""Tensor parallelism: a WaveNet stack's hidden channels split over the
devices of a mesh's "model" axis.

Counterpart of the JAX package's `tp_axis` (nn/wavenet.py:122-125, 229-233),
which shards the stack's channel dimension with GSPMD constraints and lets
XLA insert the collectives.  Here the split is explicit, in the one process
that drives the mesh (`parallel.mesh`), in the Megatron form of a gated
layer: for M model devices and a group of C hidden channels, shard s holds

- rows [s*C/M, (s+1)*C/M) of the tanh half and the same rows of the sigmoid
  half of every dilated conv (weight and bias), and those rows of its cond
  slab (`scatter_rows`);
- the matching C/M input columns of every res/skip conv, and its bias on
  shard 0 only (`shard_layer`).

Per layer (`sharded_layer`) the residual is broadcast to every model
device, each computes its gated rows and its partial res/skip product, and
the partials are summed in a fixed order into the full residual and skip on
the first model device: `torch.cuda.comm.broadcast` / `reduce_add` on the
card, `.to()` and add on the CPU (and wherever a gradient must pass, as on
the differentiable route: those are autograd ops).  The sum runs in the
compute dtype, as XLA's all-reduce does in bf16.  The start, cond and end
convs run on the first model device.  A device may repeat
(`["cuda:0", "cuda:0"]`), which exercises the shard and reduce code on a
host with one card.

The int8 mode runs under the same split (`shard_int8_layer`,
`sharded_int8_layer`).  Each weight is quantized whole first
(ops/quant.py), then sliced as above: the dilated conv's rows keep their
own per-output-channel scales, and the res/skip conv's input columns share
the full weight's.  The dilated conv's input is replicated, so each shard
quantizes it with the same per-sample scale.  The res/skip conv's input,
the gated rows, is sharded, so its per-sample abs-max is taken across the
shards first (`max_reduce`); each shard's int32 partial product is then
dequantized with the same scales, and the fp32 partials are summed as
above and cast to the compute dtype, as the unsharded int8 layer casts
its product.  `counts` holds the number of sum reduces and max reduces
run.

`shard_model` places a model's stacks that were built with
`tp_axis="model"` (`MBEXWN_TP_AXIS=model`) on a model axis; the other
stacks stay on the first device, their weights replicated, as JAX's are
without the constraint.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch.cuda import comm

from ..ops.conv import conv1d
from ..ops.quant import Int8Weight, act_absmax, conv1x1_int8_prepared, dilated_conv1d_k3_int8_prepared
from ..ops.wavenet_stack import gate

Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]
counts = {"reduce_add": 0, "max_reduce": 0}  # collectives run, for the card's report


def shard_model(model: torch.nn.Module, devices: Sequence[torch.device]) -> torch.nn.Module:
    """Place every WaveNet stack of `model` (already on devices[0]) built with
    a tp_axis on the model-axis `devices`, in place; returns the model."""
    from ..nn.wavenet import WaveNetAE

    devices = tuple(torch.device(d) for d in devices)
    for m in model.modules():
        if isinstance(m, WaveNetAE) and m.tp_axis is not None:
            if m.n_grp_channels % len(devices):
                raise ValueError(f"{m.name}: {m.n_grp_channels} channels a group do not split over "
                                 f"{len(devices)} model devices")
            m.tp_devices = devices if len(devices) > 1 else None
            m._tp_cache = m._tp_int8_cache = None
    return model


def _rows(t: torch.Tensor, s: int, M: int) -> torch.Tensor:
    """Shard s of M of the gate's rows along dim 0 (tanh half, sigmoid half)."""
    C = t.shape[0] // 2
    return t.reshape(2, M, C // M, *t.shape[1:])[:, s].reshape(2 * (C // M), *t.shape[1:])


def scatter_rows(slab: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Each model device's rows of a (B, T, 2C) cond slab, on that device."""
    M = len(devices)
    moved = slab.movedim(-1, 0)
    return [_rows(moved, s, M).movedim(0, -1).to(dev) for s, dev in enumerate(devices)]


def shard_layer(conv, res_skip, dtype: torch.dtype, devices: Sequence[torch.device]) -> List[Shard]:
    """(dilated weight rows, their bias, res/skip input columns, the res/skip
    bias on shard 0 else None) on each model device, in `dtype`, sliced
    from the convs' (folded) weights; differentiable."""
    M = len(devices)
    w_dil, b_dil = conv.kernel().to(dtype), conv.bias.to(dtype)
    w_rs, b_rs = res_skip.kernel().to(dtype), res_skip.bias.to(dtype)
    Cs = w_rs.shape[1] // M
    return [(_rows(w_dil, s, M).to(dev), _rows(b_dil, s, M).to(dev),
             w_rs[:, s * Cs:(s + 1) * Cs].to(dev), b_rs.to(dev) if s == 0 else None)
            for s, dev in enumerate(devices)]


def _comm(tensors) -> bool:
    """torch.cuda.comm serves CUDA tensors that carry no gradient."""
    return all(t.device.type == "cuda" for t in tensors) and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in tensors))


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """x on each of `devices` (x itself where it already lies)."""
    if _comm([x]) and all(d.type == "cuda" for d in devices):
        return list(comm.broadcast(x, devices=[d.index for d in devices]))
    return [x.to(d) for d in devices]


def reduce_add(partials: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The sum of the partials on `home`, in their dtype."""
    counts["reduce_add"] += 1
    if _comm(partials) and home.type == "cuda":
        return comm.reduce_add(list(partials), destination=home.index)
    out = partials[0].to(home)
    for p in partials[1:]:
        out = out + p.to(home)
    return out


def sharded_layer(x: torch.Tensor, cond: Optional[List[torch.Tensor]], shards: Sequence[Shard],
                  devices: Sequence[torch.device], activation: str, dilation: int, padding: str) -> torch.Tensor:
    """One gated layer over the model devices: x (B, T, C) and the result on
    devices[0], cond the per-device rows of the layer's slab (or None) ->
    the full res/skip output."""
    partials = []
    for s, (xd, (w_dil, b_dil, w_rs, b_rs)) in enumerate(zip(broadcast(x, devices), shards)):
        y = conv1d(xd, w_dil, b_dil, 1, dilation, padding)
        if cond is not None:
            y = y + cond[s]
        partials.append(conv1d(gate(activation, *y.chunk(2, dim=-1)), w_rs, b_rs))
    return reduce_add(partials, devices[0])


def max_reduce(parts: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The elementwise max of `parts` (one per model device), on each of
    `devices`."""
    counts["max_reduce"] += 1
    out = parts[0].to(devices[0])
    for p in parts[1:]:
        out = torch.maximum(out, p.to(devices[0]))
    return broadcast(out, devices)


def shard_int8_layer(weights: Tuple[Int8Weight, Int8Weight], devices: Sequence[torch.device]):
    """Each model device's shard of a layer's int8 weights (`Int8Weight`,
    quantized whole): the dilated conv's gate rows with their scales and
    bias, and the res/skip conv's input columns with the full weight's
    scales, its bias on shard 0 only."""
    w_dil, w_rs = weights
    M = len(devices)
    Cs = w_dil.q.shape[0] // 2 // M
    return [(Int8Weight(_rows(w_dil.q, s, M).to(dev), _rows(w_dil.scale, s, M).to(dev),
                        None if w_dil.bias is None else _rows(w_dil.bias, s, M).to(dev)),
             Int8Weight(w_rs.q[:, s * Cs:(s + 1) * Cs].contiguous().to(dev), w_rs.scale.to(dev),
                        w_rs.bias.to(dev) if s == 0 and w_rs.bias is not None else None))
            for s, dev in enumerate(devices)]


def sharded_int8_layer(x: torch.Tensor, cond: Optional[List[torch.Tensor]], shards, devices: Sequence[torch.device],
                       activation: str, dilation: int) -> torch.Tensor:
    """`sharded_layer` in the int8 mode (`nn.wavenet.int8_layer` split over
    the model devices): x (B, T, C) and the result on devices[0]."""
    gated = []
    for s, (xd, (w_dil, _)) in enumerate(zip(broadcast(x, devices), shards)):
        y = dilated_conv1d_k3_int8_prepared(xd, w_dil, dilation).to(x.dtype)
        if cond is not None:
            y = y + cond[s]
        gated.append(gate(activation, *y.chunk(2, dim=-1)))
    amax = max_reduce([act_absmax(g) for g in gated], devices)
    partials = [conv1x1_int8_prepared(g, w_rs, a) for g, a, (_, w_rs) in zip(gated, amax, shards)]
    return reduce_add(partials, devices[0]).to(x.dtype)
