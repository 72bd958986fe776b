"""The post net and the PQMF synthesis as one stage: (B, T, Cin) sub-band
features -> (B, T * S) audio.

Counterpart of the tail of the JAX package's `generate_excitation`: the
post net (a width-1 conv from Cin channels to the S sub-bands, with the
equalized-LR post gain where the config has one), the optional multiband
gains, and the PQMF synthesis (ops/pqmf_ops.py: zero-stuff each used band
by S, scale by S, pad by taps/2 on each side, one VALID conv with the
(1, used, taps + 1) synthesis bank summing the bands).

`post_pqmf` is the entry point, the `torch.library` op
`mbexwn::post_pqmf`: on a CUDA tensor it launches K3 (csrc/post_pqmf.cu),
which computes the stage in one pass over x in its polyphase form (each
output sample takes only the ~(taps + 1) / S taps of a band that fall on
a non-zero sample); on a CPU tensor it runs `post_pqmf_plain`, the same
stage in plain PyTorch, which is what the model runs where it keeps a
gradient.  A fake implementation gives the shape, so `torch.export` and
`torch.compile` trace one node for the stage.  The op has no backward
pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel_lib
from .conv import conv1d
from .pqmf_ops import pqmf_synthesis

_MAX_BANDS = 8  # the kernel's kMaxBands
_MAX_PHASE_TAPS = 16  # its kPhaseTaps


def post_pqmf_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                    gain: Optional[torch.Tensor], mb_gain: Optional[torch.Tensor],
                    synthesis_filter: torch.Tensor, subbands: int, used: int) -> torch.Tensor:
    """The stage in plain PyTorch: the post net (`conv1d` of the (S, Cin)
    kernel with its bias and equalized-LR post gain, as
    `Conv1DWeightNorm.conv_args` gives them), times `mb_gain[:, :T]` when
    given, then the PQMF synthesis of the `used` first bands.  (B, T, Cin)
    -> (B, T * S).  The same ops, in the same order, as the post net's
    forward, the model's gain product and `pqmf_synthesis`."""
    y = conv1d(x, weight[:, :, None], bias, padding="VALID", gain=gain)
    if mb_gain is not None:
        y = y * mb_gain[:, : y.shape[1]]
    taps = synthesis_filter.shape[-1] - 1
    return pqmf_synthesis(y, synthesis_filter, subbands, taps, used)[:, :, 0]


def post_pqmf(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gain: Optional[torch.Tensor],
              mb_gain: Optional[torch.Tensor], synthesis_filter: torch.Tensor, subbands: int,
              used: int) -> torch.Tensor:
    """x (B, T, Cin) fp32, contiguous or a view of a contiguous (B, Cin, T)
    (the WaveNet's end conv leaves it so); the post net's folded kernel (S, Cin),
    its bias (S,) or None, its equalized-LR post gain (S,) or None; the
    multiband gain (B, >= T, S) or None (its first T rows are used); the
    synthesis filter (1, used, taps + 1) -> (B, T * S) fp32 audio.  Calls
    the op `mbexwn::post_pqmf`: CUDA tensors launch K3 once, CPU tensors
    take `post_pqmf_plain`.  Raises on what the kernel does not take."""
    _check(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used)
    return torch.ops.mbexwn.post_pqmf(x, weight, bias, gain, mb_gain, synthesis_filter, int(subbands), int(used))


def _check(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"post_pqmf: unsupported device {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("gain", gain), ("mb_gain", mb_gain),
                    ("synthesis_filter", synthesis_filter)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"post_pqmf: {name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if not (x.is_contiguous() or x.transpose(1, 2).is_contiguous()):
        raise ValueError("post_pqmf: x must be contiguous, or a (B, T, Cin) view of a contiguous (B, Cin, T)")
    for name, t in (("weight", weight), ("bias", bias), ("gain", gain), ("synthesis_filter", synthesis_filter)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"post_pqmf: {name} must be contiguous")
    if x.dim() != 3 or weight.dim() != 2 or weight.shape != (subbands, x.shape[2]):
        raise ValueError(f"post_pqmf: x {tuple(x.shape)} and weight {tuple(weight.shape)} are not (B, T, Cin) "
                         f"and (S, Cin) with S = {subbands}")
    for name, t in (("bias", bias), ("gain", gain)):
        if t is not None and t.shape != (subbands,):
            raise ValueError(f"post_pqmf: {name} {tuple(t.shape)} is not ({subbands},)")
    if mb_gain is not None and (mb_gain.dim() != 3 or mb_gain.shape[0] != x.shape[0] or mb_gain.shape[1] < x.shape[1]
                                or mb_gain.shape[2] != subbands or mb_gain.stride(2) != 1):
        raise ValueError(f"post_pqmf: mb_gain {tuple(mb_gain.shape)} is not (B, >= T, S) = ({x.shape[0]}, >= "
                         f"{x.shape[1]}, {subbands}) with unit stride over the bands")
    taps = synthesis_filter.shape[-1] - 1
    if (synthesis_filter.dim() != 3 or synthesis_filter.shape[:2] != (1, used) or not 1 <= used <= subbands
            or taps % 2):
        raise ValueError(f"post_pqmf: synthesis_filter {tuple(synthesis_filter.shape)} is not (1, used, taps + 1) "
                         f"with used = {used} <= {subbands} bands and an even taps")


@torch.library.custom_op("mbexwn::post_pqmf", mutates_args=(), device_types="cpu")
def _post_pqmf_op(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gain: Optional[torch.Tensor],
                  mb_gain: Optional[torch.Tensor], synthesis_filter: torch.Tensor, subbands: int,
                  used: int) -> torch.Tensor:
    """The op on CPU tensors: the plain version."""
    return post_pqmf_plain(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used)


@_post_pqmf_op.register_kernel("cuda")
def _post_pqmf_op_cuda(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used):
    """The op on CUDA tensors: K3, under the tensors' device."""
    with kernel_lib.on_device(x.device):
        return _post_pqmf_cuda(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used)


@_post_pqmf_op.register_fake
def _(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used):
    return x.new_empty((x.shape[0], x.shape[1] * subbands))


kernel_lib.no_backward(_post_pqmf_op, "post_pqmf")


def _post_pqmf_cuda(x, weight, bias, gain, mb_gain, synthesis_filter, subbands, used):
    """The op on CUDA tensors, under their device: one launch of K3."""
    B, T, cin = x.shape
    half = (synthesis_filter.shape[-1] - 1) // 2
    phase_taps = (half + subbands - 1) // subbands + half // subbands + 1
    if used > _MAX_BANDS or B > 65535 or phase_taps > _MAX_PHASE_TAPS:
        raise ValueError(f"post_pqmf: K3 takes at most {_MAX_BANDS} used bands, a batch of 65535 and "
                         f"{_MAX_PHASE_TAPS} taps a phase; got {used}, {B} and {phase_taps}")
    out = x.new_empty((B, T * subbands))
    if x.numel():
        lib = kernel_lib.library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        mb_bs, mb_ts = (mb_gain.stride(0), mb_gain.stride(1)) if mb_gain is not None else (0, 0)
        err = lib.mbexwn_post_pqmf(x.data_ptr(), int(not x.is_contiguous()), weight.data_ptr(),
                                   None if bias is None else bias.data_ptr(),
                                   None if gain is None else gain.data_ptr(),
                                   None if mb_gain is None else mb_gain.data_ptr(), mb_bs, mb_ts,
                                   synthesis_filter.data_ptr(), out.data_ptr(), B, T, cin, subbands, used,
                                   synthesis_filter.shape[-1] - 1, stream)
        kernel_lib.check(err, "post_pqmf")
        kernel_lib.launches["post_pqmf"] += 1
    return out
