"""Float32 precision policy on the card.

A float32 convolution goes through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps ~10 mantissa bits:
the same kind of operand truncation that cost the JAX package's quality gate
2.4 dB on the TPU until its sensitive products ran at HIGHEST precision.
The fp32 model convs, the rDFT of the cepstral envelope, the cepstral-window
select and the mel pseudo-inverse must run in true fp32, so synthesis runs
inside `exact_fp32()`.  Reduced-precision (bf16) compute is chosen by dtype
(`wn_compute_dtype` / `subnet_compute_dtype`), never by TF32.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_fp32():
    """Disable TF32 for cuDNN convs and cuBLAS matmuls, restoring after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
