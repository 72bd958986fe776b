"""1-D convolution primitives on (batch, time, channels) tensors.

Counterpart of the JAX package's ops/conv.py.  Activations keep the JAX
package's (B, T, C) layout at every public function; kernels are PyTorch's
(out, in, width) "OIW" layout, so `F.conv1d` takes them as they are.  TF's
SAME (including strided), VALID and CAUSAL paddings are applied explicitly
before a VALID `F.conv1d`, because PyTorch's own "same" differs from TF's
for even effective widths and does not support strides.

Weight-normalised kernels fold to `g * v / ||v||` with eps 1e-12, as in
the JAX package: `weight_norm_kernel` / `equalized_lr_kernel` on OIW
tensors (differentiable, the forward pass of a trainable conv), and
`fold_weight_norm` on a stored WIO tree, before
`compat.params_io.params_from_jax` transposes it to OIW (loading a
model in its folded, inference form).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def same_pads(kernel_size: int, dilation: int = 1, stride: int = 1, in_len: Optional[int] = None) -> Tuple[int, int]:
    """TF-compatible SAME padding (lo, hi) for a 1-D conv."""
    k_eff = (kernel_size - 1) * dilation + 1
    if stride == 1:
        total = k_eff - 1
    else:
        if in_len is None:
            raise ValueError("SAME padding with stride > 1 requires the input length")
        out_len = -(-in_len // stride)
        total = max(0, (out_len - 1) * stride + k_eff - in_len)
    lo = total // 2
    return lo, total - lo


def causal_pads(kernel_size: int, dilation: int = 1) -> Tuple[int, int]:
    k_eff = (kernel_size - 1) * dilation + 1
    return k_eff - 1, 0


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    padding: str = "SAME",
    gain: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Conv over (B, T, Cin) with an OIW weight (Cout, Cin, W) -> (B, T', Cout).

    The weight and bias are cast to x's dtype, as the JAX package casts its
    params to the compute dtype; accumulation is fp32 in both frameworks.
    With a per-channel `gain` (Cout,), the equalized-LR post gain, the
    result is gain * conv (+ bias), each step rounded in x's dtype.
    """
    width = weight.shape[-1]
    if padding == "SAME":
        lo, hi = same_pads(width, dilation, stride, x.shape[1])
    elif padding == "CAUSAL":
        lo, hi = causal_pads(width, dilation)
    elif padding == "VALID":
        lo, hi = 0, 0
    else:
        raise ValueError(f"unsupported padding {padding}")
    xt = x.transpose(1, 2)
    if lo or hi:
        xt = F.pad(xt, (lo, hi))
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv1d(xt, weight.to(x.dtype), b if gain is None else None, stride=stride, dilation=dilation)
    y = y.transpose(1, 2)
    if gain is None:
        return y
    y = gain.to(x.dtype) * y
    return y if b is None else y + b


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kernel = g * v / ||v||_2 of an OIW tensor, the norm over (in, width)
    per out-channel (tf.nn.l2_normalize's eps 1e-12); differentiable, the
    fold of a trainable conv."""
    norm = torch.sqrt(torch.clamp((v * v).sum(dim=(1, 2), keepdim=True), min=1e-12))
    return g[:, None, None] * (v / norm)


def equalized_lr_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """kernel = g * v / rms(v) of an OIW tensor (the equalized-LR variant);
    differentiable."""
    rms = torch.sqrt((v * v).mean(dim=(1, 2), keepdim=True))
    return g[:, None, None] * (v / rms)


def fold_weight_norm(params: dict) -> dict:
    """Recursively replace {v, g} pairs by a folded {kernel} in a param tree."""
    if isinstance(params, dict):
        if "v" in params and "g" in params:
            out = {k: vv for k, vv in params.items() if k not in ("v", "g", "_equalized_lr")}
            fold = equalized_lr_kernel if params.get("_equalized_lr", False) else weight_norm_kernel
            v = torch.from_numpy(np.asarray(params["v"], np.float32)).permute(2, 1, 0)  # WIO -> OIW
            kernel = fold(v, torch.from_numpy(np.asarray(params["g"], np.float32)))
            out["kernel"] = np.ascontiguousarray(kernel.permute(2, 1, 0).numpy())
            return out
        return {k: fold_weight_norm(vv) for k, vv in params.items()}
    return params
