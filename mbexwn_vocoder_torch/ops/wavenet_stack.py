"""The dilated gated WaveNet stack: per layer
    y  = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b + cond        (C -> 2C)
    g  = tanh(y[:C]) * sigmoid(y[C:])
    rs = g W_rs + b_rs                                      (C -> 2C)
    x <- x + rs[:C]  (zero outside [0, T)),   skip += rs[C:]
with a skip-only last layer (W_rs is C -> C).

Counterpart of the JAX package's ops/pallas_wavenet.py
(`fused_wavenet_stack`).  `wavenet_stack` is the entry point: on a CUDA
tensor it launches the CUDA kernel `csrc/wavenet_layer.cu` once per layer;
on a CPU tensor it runs `wavenet_stack_plain`, the same function in plain
PyTorch.  Both round x and the gated activation to the operand dtype where
the JAX kernel does, and keep the skip sum in fp32.

Weights are "N-major", each output channel's inputs contiguous, which is
PyTorch's (out, in) order and the layout the kernel's tensor-core operand
wants: w_dil (2C, 3, C) (`conv.weight.permute(0, 2, 1)`), w_rs (2C, C) or,
for a skip-only layer, (C, C); biases (2C,) / (C,).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import kernel_lib

LayerWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gate(activation: str, half_act: torch.Tensor, half_sigmoid: torch.Tensor) -> torch.Tensor:
    """Gated units gtu/glu/gfu/gsu."""
    if activation == "gtu":
        half_act = torch.tanh(half_act)
    elif activation == "gfu":
        half_act = half_act / (1.0 + torch.abs(half_act))
    elif activation == "gsu":
        half_act = half_act / (1.0 + torch.sqrt(torch.abs(half_act)))
    elif activation != "glu":
        raise ValueError(f"unsupported gate {activation}")
    return half_act * torch.sigmoid(half_sigmoid)


def wavenet_stack_plain(x: torch.Tensor, cond: torch.Tensor, layer_weights: Sequence[LayerWeights],
                        dils: Sequence[int], activation: str = "gtu") -> torch.Tensor:
    """(B, T, C) x, (B, T, 2C) cond -> (B, T, C) fp32 skip sum, in plain PyTorch
    (fp32 products of the operand-dtype values)."""
    B, T, C = x.shape
    dtype = x.dtype
    cond32 = cond.float()
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for (wd, bd, wr, br), d in zip(layer_weights, dils):
        xp = F.pad(x.float(), (0, 0, d, d))
        wd = wd.float()
        y = (xp[:, :T] @ wd[:, 0].t() + xp[:, d : d + T] @ wd[:, 1].t() + xp[:, 2 * d : 2 * d + T] @ wd[:, 2].t()
             + bd.float() + cond32)
        g = gate(activation, y[..., :C], y[..., C:]).to(dtype)
        rs = g.float() @ wr.float().t() + br.float()
        if rs.shape[-1] == 2 * C:
            x = (x.float() + rs[..., :C]).to(dtype)
            skip += rs[..., C:]
        else:
            skip += rs
    return skip


def wavenet_layer(x_in: torch.Tensor, cond: torch.Tensor, w_dil: torch.Tensor, b_dil: torch.Tensor,
                  w_rs: torch.Tensor, b_rs: torch.Tensor, x_out: torch.Tensor, skip: torch.Tensor,
                  dilation: int) -> None:
    """Launch one layer of the CUDA kernel: writes x_out, adds into skip.

    Weights as in the module docstring.  A skip-only layer (w_rs (C, C),
    b_rs (C,)) adds into skip and leaves x_out unwritten.  x_out must not
    alias x_in: neighbouring tiles read x_in at t +- d.  bf16 needs C to be
    a multiple of 4 (8-byte vector loads).
    """
    B, T, C = x_in.shape
    dtype = x_in.dtype
    n_rs = w_rs.shape[0]
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"wavenet_layer: dtype {dtype} is not float32 or bfloat16")
    if dtype == torch.bfloat16 and C % 4:
        raise ValueError(f"wavenet_layer: bf16 needs C % 4 == 0, got C={C}")
    expected = {"x_in": (x_in, (B, T, C), dtype), "cond": (cond, (B, T, 2 * C), dtype),
                "w_dil": (w_dil, (2 * C, 3, C), dtype), "b_dil": (b_dil, (2 * C,), dtype),
                "w_rs": (w_rs, (n_rs if n_rs == C else 2 * C, C), dtype), "b_rs": (b_rs, (n_rs,), dtype),
                "x_out": (x_out, (B, T, C), dtype), "skip": (skip, (B, T, C), torch.float32)}
    for name, (t, shape, dt) in expected.items():
        if t.device != x_in.device or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"wavenet_layer: {name} must be a contiguous {dt} tensor of shape {shape} on "
                             f"{x_in.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x_out.data_ptr() == x_in.data_ptr():
        raise ValueError("wavenet_layer: x_out must not alias x_in")
    if B == 0 or T == 0:
        return
    lib = kernel_lib.library()
    stream = torch.cuda.current_stream(x_in.device).cuda_stream
    err = lib.mbexwn_wavenet_layer(_KERNEL_DTYPES[dtype], x_in.data_ptr(), cond.data_ptr(), w_dil.data_ptr(),
                                   b_dil.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(), x_out.data_ptr(),
                                   skip.data_ptr(), B, T, C, int(dilation), int(n_rs == C), stream)
    kernel_lib.check(err, "wavenet_layer")
    kernel_lib.launches["wavenet_layer"] += 1


def wavenet_stack(x: torch.Tensor, cond: torch.Tensor, layer_weights: Sequence[LayerWeights],
                  dils: Sequence[int], activation: str = "gtu") -> torch.Tensor:
    """(B, T, C) x and (B, T, 2C) cond in the operand dtype (fp32 or bf16),
    weights as listed in the module docstring -> (B, T, C) fp32 skip sum.
    CUDA tensors launch the kernel per layer; CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return wavenet_stack_plain(x, cond, layer_weights, dils, activation)
    if x.device.type != "cuda":
        raise RuntimeError(f"wavenet_stack: unsupported device {x.device}")
    if activation != "gtu":
        raise NotImplementedError(f"the CUDA kernel computes the gtu gate only, not {activation} "
                                  f"(ROADMAP.md queue 1, item 13)")
    B, T, C = x.shape
    cond = cond.contiguous()
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    # ping-pong between two fresh buffers; the caller's x is only read
    bufs = [torch.empty((B, T, C), dtype=x.dtype, device=x.device) for _ in range(2)]
    cur = x.contiguous()
    for i, ((wd, bd, wr, br), d) in enumerate(zip(layer_weights, dils)):
        wavenet_layer(cur, cond, wd, bd, wr, br, bufs[i % 2], skip, d)
        cur = bufs[i % 2]
    return skip
