"""The dilated gated WaveNet stack: per layer
    y  = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b + cond        (C -> 2C; SAME)
    y  = x[t-2d] W0 + x[t-d] W1 + x[t] W2 + b + cond       (C -> 2C; causal)
    g  = tanh(y[:C]) * sigmoid(y[C:])
    rs = g W_rs + b_rs                                      (C -> 2C)
    x <- x + rs[:C]  (zero outside [0, T)),   skip += rs[C:]
with a skip-only last layer (W_rs is C -> C).

Counterpart of the JAX package's ops/pallas_wavenet.py
(`fused_wavenet_stack`).  `wavenet_stack` is the entry point: on a CUDA
tensor it enqueues the CUDA kernel `csrc/wavenet_layer.cu` for every layer
with one host call; on a CPU tensor it runs `wavenet_stack_plain`, the same
function in plain PyTorch.  Both round x and the gated activation to the
operand dtype where the JAX kernel does, and keep the skip sum in fp32.

Weights are "N-major", each output channel's inputs contiguous, which is
PyTorch's (out, in) order and the layout the kernel's tensor-core operand
wants: w_dil (2C, 3, C) (`conv.weight.permute(0, 2, 1)`), w_rs (2C, C) or,
for a skip-only layer, (C, C); biases (2C,) / (C,).

The kernel's operand layout pads the reduction dimension with zeros to
`padded_channels(C)`, a multiple of 64, so that every row starts 128-byte
aligned: w_dil (2C, 3, Cp), w_rs (., Cp) and x (B, T, Cp); the biases and the
skip sum keep their widths, and so does cond except in bf16 at a C that is
not a multiple of 8 (`_kernel_cond`).  `pack_stack_weights` brings a list of
layers into that layout once (`PackedStackWeights`); `wavenet_stack` and
`wavenet_stack_plain` take either form.  The pad contributes exact zeros to
the kernel's products; the plain version does not read it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import kernel_lib

LayerWeights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TENSOR_MAP_BYTES = 128
_CHANNEL_ALIGN = 64  # elements: one 128-byte swizzle row of bf16, the kernel's reduction slice


def padded_channels(C: int) -> int:
    """The kernel layout's row length for C channels (320 -> 320, 340 -> 384)."""
    return -(-C // _CHANNEL_ALIGN) * _CHANNEL_ALIGN


@dataclass
class PackedStackWeights:
    """A stack's layers in the kernel's operand layout: per layer
    (w_dil (2C, 3, Cp), b_dil (2C,), w_rs (2C or C, Cp), b_rs), zeros in the
    pad, all of one dtype on one device, checked once when packed."""
    layers: List[LayerWeights]
    C: int
    C_pad: int
    _launch_args: dict = field(default_factory=dict, repr=False)

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, index):
        return self.layers[index]

    @property
    def dtype(self) -> torch.dtype:
        return self.layers[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.layers[0][0].device

    def launch_args(self):
        """ctypes arrays of the per-layer device pointers and skip-only flags
        and, for bf16, the host buffer of the weights' tensor maps: built at
        the first launch and kept, since they depend on nothing but this
        weight set."""
        if not self._launch_args:
            n = len(self.layers)
            ptrs = [(ctypes.c_void_p * n)(*[lw[k].data_ptr() for lw in self.layers]) for k in range(4)]
            skip_only = (ctypes.c_int * n)(*[int(lw[2].shape[0] == self.C) for lw in self.layers])
            maps = None
            if self.dtype == torch.bfloat16:
                lib = kernel_lib.library()
                maps = torch.zeros((n, 2, _TENSOR_MAP_BYTES), dtype=torch.uint8)
                for i, (wd, _, wr, _) in enumerate(self.layers):
                    kernel_lib.check(lib.mbexwn_wavenet_weight_maps(maps[i].data_ptr(), wd.data_ptr(), wr.data_ptr(),
                                                                    self.C, self.C_pad, wr.shape[0]),
                                     "wavenet_layer (tensor map of the weights)")
            self._launch_args.update(ptrs=ptrs, skip_only=skip_only, maps=maps)
        return self._launch_args["ptrs"], self._launch_args["skip_only"], self._launch_args["maps"]


StackWeights = Union[PackedStackWeights, Sequence[LayerWeights]]


def pack_stack_weights(layer_weights: Sequence[LayerWeights]) -> PackedStackWeights:
    """Check a stack's layers (w_dil (2C, 3, C), b_dil (2C,), w_rs (2C or C, C),
    b_rs, one dtype, one device) and pad their reduction dimension to the
    kernel layout."""
    if not layer_weights:
        raise ValueError("pack_stack_weights: a stack needs at least one layer")
    w0 = layer_weights[0][0]
    C, Cp = w0.shape[-1], padded_channels(w0.shape[-1])
    layers = []
    for i, (wd, bd, wr, br) in enumerate(layer_weights):
        n_rs = wr.shape[0]
        expected = {"w_dil": (wd, (2 * C, 3, C)), "b_dil": (bd, (2 * C,)),
                    "w_rs": (wr, (n_rs if n_rs == C else 2 * C, C)), "b_rs": (br, (n_rs,))}
        for name, (t, shape) in expected.items():
            if t.device != w0.device or t.dtype != w0.dtype or tuple(t.shape) != shape:
                raise ValueError(f"pack_stack_weights: layer {i} {name} must be a {w0.dtype} tensor of shape {shape} "
                                 f"on {w0.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        layers.append((_pad_columns(wd, Cp - C).contiguous(), bd.contiguous(),
                       _pad_columns(wr, Cp - C).contiguous(), br.contiguous()))
    return PackedStackWeights(layers, C, Cp)


def _pad_columns(t: torch.Tensor, n: int) -> torch.Tensor:
    """`t` with n zero columns appended (itself when n is 0)."""
    return F.pad(t, (0, n)) if n else t


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


def wavenet_stack_plain(x: torch.Tensor, cond: torch.Tensor, layer_weights: StackWeights,
                        dils: Sequence[int], activation: str = "gtu", causal: bool = False) -> torch.Tensor:
    """(B, T, C) x, (B, T, 2C) cond -> (B, T, C) fp32 skip sum, in plain PyTorch
    (fp32 products of the operand-dtype values); `causal` shifts the taps to
    t-2d, t-d, t (the pad goes left).  Takes the layers as listed
    in the module docstring or packed, and x with C or Cp columns: it reads
    the first C columns of x and of the weights' reduction dimension only, so
    padded and unpadded operands go through the very same arithmetic (the pad
    is zero by contract; the kernel multiplies it, the tests check it)."""
    layers = layer_weights.layers if isinstance(layer_weights, PackedStackWeights) else layer_weights
    B, T, _ = x.shape
    C = cond.shape[-1] // 2
    if x.shape[-1] < C:
        raise ValueError(f"wavenet_stack_plain: x has {x.shape[-1]} columns, cond implies C={C}")
    x = x[..., :C]
    dtype = x.dtype
    cond32 = cond.float()
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for (wd, bd, wr, br), d in zip(layers, dils):
        xp = F.pad(x.float(), (0, 0, 2 * d, 0) if causal else (0, 0, d, d))
        wd = wd[..., :C].float()
        y = (xp[:, :T] @ wd[:, 0].t() + xp[:, d : d + T] @ wd[:, 1].t() + xp[:, 2 * d : 2 * d + T] @ wd[:, 2].t()
             + bd.float() + cond32)
        g = gate(activation, y[..., :C], y[..., C:]).to(dtype)
        rs = g.float() @ wr[..., :C].float().t() + br.float()
        if rs.shape[-1] == 2 * C:
            x = (x.float() + rs[..., :C]).to(dtype)
            skip += rs[..., C:]
        else:
            skip += rs
    return skip


def _kernel_cond(cond: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """cond (B, T, 2C) as the kernel reads it, and the distance Ch between its
    halves.  The bf16 kernel fetches each half with TMA, whose boxes start on
    16-byte boundaries: where C is not a multiple of 8 (VOICE's 340) the
    halves are copied to columns 0 and Ch = C rounded up to 8, zeros between.
    fp32, and bf16 at a multiple of 8 (SPEECH's 320), take cond as it is."""
    B, T, C2 = cond.shape
    C = C2 // 2
    Ch = C if cond.dtype != torch.bfloat16 else -(-C // 8) * 8
    if Ch != C:
        cond = F.pad(cond.reshape(B, T, 2, C), (0, Ch - C)).view(B, T, 2 * Ch)
    return cond.contiguous(), Ch


def _check_operand(fn: str, name: str, t: torch.Tensor, shape, dtype, device, contiguous: bool = True) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) or (contiguous and not t.is_contiguous()):
        raise ValueError(f"{fn}: {name} must be a contiguous {dtype} tensor of shape {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_kernel_dtype(fn: str, dtype: torch.dtype, C: int) -> None:
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{fn}: dtype {dtype} is not float32 or bfloat16")
    if dtype == torch.bfloat16 and C % 4:
        raise ValueError(f"{fn}: bf16 needs C % 4 == 0, got C={C}")


def wavenet_layer(x_in: torch.Tensor, cond: torch.Tensor, w_dil: torch.Tensor, b_dil: torch.Tensor,
                  w_rs: torch.Tensor, b_rs: torch.Tensor, x_out: torch.Tensor, skip: torch.Tensor,
                  dilation: int, causal: bool = False) -> None:
    """Launch one layer of the CUDA kernel in the kernel's operand layout:
    x_in and x_out (B, T, Cp) with zeros in the pad columns, cond (B, T, 2C),
    w_dil (2C, 3, Cp), w_rs (2C or C, Cp), skip (B, T, C) fp32.  Writes
    columns < C of x_out and adds into skip; a skip-only layer (w_rs (C, Cp),
    b_rs (C,)) leaves x_out unwritten.  x_out must not alias x_in:
    neighbouring tiles read x_in at t +- d.  `wavenet_stack` is the entry
    point of the model; this one serves tests of single layers."""
    B, T, Cp = x_in.shape
    C = cond.shape[-1] // 2
    dtype, dev = x_in.dtype, x_in.device
    n_rs = w_rs.shape[0]
    _check_kernel_dtype("wavenet_layer", dtype, C)
    if Cp != padded_channels(C):
        raise ValueError(f"wavenet_layer: x_in has {Cp} columns, the kernel layout of C={C} has {padded_channels(C)}")
    for name, t, shape, dt in (("x_in", x_in, (B, T, Cp), dtype), ("cond", cond, (B, T, 2 * C), dtype),
                               ("w_dil", w_dil, (2 * C, 3, Cp), dtype), ("b_dil", b_dil, (2 * C,), dtype),
                               ("w_rs", w_rs, (n_rs if n_rs == C else 2 * C, Cp), dtype), ("b_rs", b_rs, (n_rs,), dtype),
                               ("x_out", x_out, (B, T, Cp), dtype), ("skip", skip, (B, T, C), torch.float32)):
        _check_operand("wavenet_layer", name, t, shape, dt, dev)
    if x_out.data_ptr() == x_in.data_ptr():
        raise ValueError("wavenet_layer: x_out must not alias x_in")
    if B == 0 or T == 0:
        return
    lib = kernel_lib.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cond, Ch = _kernel_cond(cond)
    with kernel_lib.on_device(dev):
        n = lib.mbexwn_wavenet_layer(_KERNEL_DTYPES[dtype], x_in.data_ptr(), cond.data_ptr(), w_dil.data_ptr(),
                                     b_dil.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(), x_out.data_ptr(),
                                     skip.data_ptr(), B, T, C, Cp, Ch, int(dilation), int(n_rs == C), int(causal),
                                     stream)
    kernel_lib.launches["wavenet_layer"] += kernel_lib.launched(n, "wavenet_layer")


def wavenet_stack(x: torch.Tensor, cond: torch.Tensor, layer_weights: StackWeights,
                  dils: Sequence[int], activation: str = "gtu", causal: bool = False) -> torch.Tensor:
    """(B, T, C) x and (B, T, 2C) cond in the operand dtype (fp32 or bf16),
    weights as listed in the module docstring or packed by
    `pack_stack_weights` -> (B, T, C) fp32 skip sum; `causal` selects the
    taps t-2d, t-d, t in place of t-d, t, t+d.  CUDA tensors go through
    the kernel: x is copied once into a zero-padded (B, T, Cp) buffer, the
    layers ping-pong between that and a second one, and one host call
    enqueues them all.  CPU tensors take the plain version.  The kernel has
    no backward pass: with grad mode on, CUDA inputs that require grad
    raise."""
    if x.device.type == "cpu":
        return wavenet_stack_plain(x, cond, layer_weights, dils, activation, causal)
    if x.device.type != "cuda":
        raise RuntimeError(f"wavenet_stack: unsupported device {x.device}")
    if activation != "gtu":
        raise NotImplementedError(f"the CUDA kernel computes the gtu gate only, not {activation} "
                                  f"(ROADMAP.md queue 1, item 13)")
    with kernel_lib.on_device(x.device):
        return _wavenet_stack_cuda(x, cond, layer_weights, dils, causal)


def _wavenet_stack_cuda(x, cond, layer_weights, dils, causal):
    """`wavenet_stack` on CUDA tensors, under their device."""
    packed = layer_weights if isinstance(layer_weights, PackedStackWeights) else pack_stack_weights(layer_weights)
    kernel_lib.refuse_grad("wavenet_layer", x, cond, *(t for lw in packed.layers for t in lw))
    B, T, C = x.shape
    _check_kernel_dtype("wavenet_stack", x.dtype, C)
    if packed.C != C or packed.dtype != x.dtype or packed.device != x.device:
        raise ValueError(f"wavenet_stack: weights are C={packed.C} {packed.dtype} on {packed.device}, "
                         f"x is C={C} {x.dtype} on {x.device}")
    if len(dils) != len(packed.layers):
        raise ValueError(f"wavenet_stack: {len(dils)} dilations for {len(packed.layers)} layers")
    _check_operand("wavenet_stack", "cond", cond, (B, T, 2 * C), x.dtype, x.device, contiguous=False)
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return skip
    Cp = packed.C_pad
    # ping-pong buffers in the kernel layout; the caller's x is only read
    alloc = torch.empty if Cp == C else torch.zeros
    bufs = alloc((2, B, T, Cp), dtype=x.dtype, device=x.device)
    bufs[0, :, :, :C].copy_(x)
    n = len(packed.layers)
    ptrs, skip_only, maps = packed.launch_args()
    cond, Ch = _kernel_cond(cond)
    count = kernel_lib.library().mbexwn_wavenet_stack(
        _KERNEL_DTYPES[x.dtype], n, bufs[0].data_ptr(), bufs[1].data_ptr(), cond.data_ptr(), *ptrs,
        (ctypes.c_int * n)(*[int(d) for d in dils]), skip_only, None if maps is None else maps.data_ptr(),
        skip.data_ptr(), B, T, C, Cp, Ch, int(causal), torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.launches["wavenet_layer"] += kernel_lib.launched(count, "wavenet_layer")
    return skip
