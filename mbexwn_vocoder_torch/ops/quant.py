"""The int8 mode of the WaveNet stack (opt-in, `MBEXWN_WN_QUANT=int8`).

Counterpart of the JAX package's ops/quant.py.  Dynamic post-training
quantization, as there:
- weights: symmetric per-output-channel int8, scale = absmax / 127;
- activations: symmetric per-sample (batch row) int8, the absmax taken on
  the live tensor, so each utterance of a batch gets its own scale;
- quantization divides by the scale (a multiplication by its reciprocal
  moves round-half ties into the next bin), rounds half to even and clips
  to +-127;
- the product accumulates in int32 and is dequantized in fp32 with the
  product of the two scales; the bias is added in fp32.

The dilated k=3 conv is one int8 product over the 3*C_in concatenated taps
(three shifted time slices of one quantized, zero-padded input).  The
int8 x int8 -> int32 product is `torch._int_mm` (the JAX package's is an
XLA `dot_general`, not a Pallas kernel).  On a card it wants more than 16
rows and a reduction and output width that are multiples of 8, so
`int8_matmul` pads with zero rows and channels, which is exact in integer
arithmetic; it pads on the CPU alike, so the CPU tests run the same code.
Each product adds one to `int_mm_calls`.

Under tensor parallelism (parallel/tensor.py) each weight is quantized
whole and then sliced, so every shard keeps the full tensor's
per-output-channel scales, and a sharded activation is quantized with the
abs-max of the whole tensor (`amax`).

Weights are PyTorch's OIW (Cout, Cin, W) or (Cout, Cin).  Inference only:
rounding has no gradient, so the trainer refuses to run with the mode set.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

QUANT_ENV = "MBEXWN_WN_QUANT"
_ALIGN = 8  # torch._int_mm: reduction and output widths a multiple of 8 on a card
_MIN_ROWS = 17  # and more than 16 rows

int_mm_calls = 0


def wn_quant_mode() -> str:
    """The quantized mode asked for, read at call time ("" or "int8")."""
    return os.environ.get(QUANT_ENV, "").strip().lower()


def _round_clip(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)


def quantize_weight_per_cout(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of an OIW (Cout, Cin,
    W) or (Cout, Cin) weight -> (int8 weight, fp32 scale (Cout,))."""
    w32 = weight.float()
    amax = w32.abs().amax(dim=tuple(range(1, w32.ndim)))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _round_clip(w32, scale.view(-1, *([1] * (w32.ndim - 1)))), scale


def act_absmax(x: torch.Tensor) -> torch.Tensor:
    """The per-sample fp32 abs-max of (B, ...) activations, (B, 1, ...)."""
    return x.float().abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)


def quantize_act_per_sample(x: torch.Tensor, amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-sample dynamic int8 quantization of (B, ...) activations
    -> (int8 tensor, fp32 scale (B, 1, ...) broadcastable against x).
    `amax`, when given, is the abs-max to scale by (`act_absmax` of the
    whole tensor when x is one shard of it)."""
    x32 = x.float()
    if amax is None:
        amax = act_absmax(x32)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    return _round_clip(x32, scale), scale


def _pad_to(n: int, align: int) -> int:
    return -(-n // align) * align


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K) int8 transposed -> (..., N) int32, through
    `torch._int_mm`, with K and N padded with zero channels to multiples of
    8 and the rows to at least 17 (exact: zeros add nothing to an integer
    sum).  `wq` may already carry its K pad (K_w >= K, zeros beyond K)."""
    global int_mm_calls
    lead, K = xq.shape[:-1], xq.shape[-1]
    N, Kw = wq.shape
    Kp = _pad_to(max(K, Kw), _ALIGN)
    Np = _pad_to(N, _ALIGN)
    a = xq.reshape(-1, K)
    M = a.shape[0]
    if Kp != K or M < _MIN_ROWS:
        a = F.pad(a, (0, Kp - K, 0, max(0, _MIN_ROWS - M)))
    if Kp != Kw or Np != N:
        wq = F.pad(wq, (0, Kp - Kw, 0, Np - N))
    out = torch._int_mm(a, wq.t())
    int_mm_calls += 1
    return out[:M, :N].reshape(*lead, N)


def _dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """int32 -> fp32 with the product of the scales, plus the fp32 bias."""
    y = acc.float() * (sx * sw)
    return y if bias is None else y + bias


def conv1x1_int8(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv over (B, T, Cin) with an OIW weight (Cout, Cin, 1) or
    (Cout, Cin): int8 operands, int32 accumulation, fp32 output."""
    return conv1x1_int8_prepared(x, Int8Weight.of(weight, bias))


def dilated_conv1d_k3_int8(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                           dilation: int = 1) -> torch.Tensor:
    """SAME-padded dilated k=3 conv over (B, T, Cin) with an OIW weight (Cout,
    Cin, 3) as one int8 product over the 3*Cin concatenated taps:
    y[t] = x[t-d] W0 + x[t] W1 + x[t+d] W2 (zeros outside), fp32 output."""
    if weight.shape[-1] != 3:
        raise ValueError(f"dilated_conv1d_k3_int8 requires kernel width 3, got {weight.shape[-1]}")
    return dilated_conv1d_k3_int8_prepared(x, Int8Weight.of(weight, bias), dilation)


@dataclass
class Int8Weight:
    """A conv weight quantized once: `q` (Cout, K) int8 with the taps of a
    k=3 weight concatenated tap-major on K (K = 3*Cin) and zero channels up
    to a multiple of 8, its per-output-channel fp32 `scale` and the fp32
    `bias` (or None)."""
    q: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]

    @classmethod
    def of(cls, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> "Int8Weight":
        if weight.ndim == 2:
            weight = weight[:, :, None]
        q, scale = quantize_weight_per_cout(weight)
        cout, cin, width = q.shape
        q = q.permute(0, 2, 1).reshape(cout, width * cin)  # taps stack on the reduction axis
        q = F.pad(q, (0, _pad_to(width * cin, _ALIGN) - width * cin)).contiguous()
        return cls(q, scale, None if bias is None else bias.detach().float())


def conv1x1_int8_prepared(x: torch.Tensor, w: Int8Weight, amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`conv1x1_int8` with a weight quantized beforehand (`Int8Weight.of`);
    `amax` as `quantize_act_per_sample` takes it."""
    xq, sx = quantize_act_per_sample(x, amax)
    return _dequantize(int8_matmul(xq, w.q), sx, w.scale, w.bias)


def dilated_conv1d_k3_int8_prepared(x: torch.Tensor, w: Int8Weight, dilation: int = 1) -> torch.Tensor:
    """`dilated_conv1d_k3_int8` with a weight quantized beforehand."""
    B, T, C = x.shape
    d = int(dilation)
    xq, sx = quantize_act_per_sample(x)
    xp = F.pad(xq, (0, 0, d, d))
    taps = torch.cat([xp[:, k * d: k * d + T] for k in range(3)], dim=-1)  # (B, T, 3C)
    return _dequantize(int8_matmul(taps, w.q), sx, w.scale, w.bias)
