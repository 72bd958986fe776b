"""The dilated gated WaveNet stack: per layer
    y  = x[t-d] W0 + x[t] W1 + x[t+d] W2 + b + cond_i      (C -> 2C; SAME)
    y  = x[t-2d] W0 + x[t-d] W1 + x[t] W2 + b + cond_i     (C -> 2C; causal)
    g  = tanh(y[:C]) * sigmoid(y[C:])
    rs = g W_rs + b_rs                                      (C -> 2C)
    x <- x + rs[:C]  (zero outside [0, T)),   skip += rs[C:]
with a skip-only last layer (W_rs is C -> C).  cond_i is one slab shared by
every layer, cond (B, T, 2C), or layer i's own, cond[:, :, i] of a per-layer
cond (B, T, L, 2C): a per-layer cond conv's channels-last output viewed with
a layer axis (WaveGlow's WN), which the kernel reads in place, each layer's
rows L x 2C apart.

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
layers into that layout once, stacked into four tensors
(`PackedStackWeights`: w_dil (n, 2C, 3, Cp), b_dil (n, 2C), w_rs
(n, 2C, Cp), b_rs (n, 2C), a skip-only layer's rows C..2C zero, and one
skip-only flag a layer); `wavenet_stack` and `wavenet_stack_plain` take
either form.  The pad contributes exact zeros to the kernel's products;
the plain version does not read it.

The stack is the `torch.library` custom op `mbexwn::wavenet_stack` (the
four stacked weights, the dilations, the skip-only flags, the gate and
`causal` as arguments): its CUDA implementation launches the kernel, its
CPU implementation is the plain version, and a fake implementation gives
the skip sum's shape, so a traced or exported graph holds one node per
stack.  The kernel's host-side launch arguments (the per-layer pointer
arrays and, in bf16, the weights' tensor maps) are built inside the CUDA
implementation and kept by the weights' device addresses, so a program
loaded from disk, whose weights live elsewhere, builds its own.
"""
from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from dataclasses import dataclass
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
    """A stack's n layers in the kernel's operand layout, stacked: w_dil
    (n, 2C, 3, Cp), b_dil (n, 2C), w_rs (n, 2C, Cp), b_rs (n, 2C), zeros in
    the pad and in the rows C..2C of a skip-only layer (`skip_only[i]`), all
    contiguous, of one dtype on one device, checked once when packed."""
    w_dil: torch.Tensor
    b_dil: torch.Tensor
    w_rs: torch.Tensor
    b_rs: torch.Tensor
    skip_only: Tuple[bool, ...]
    C: int
    C_pad: int

    def __len__(self) -> int:
        return len(self.skip_only)

    def __getitem__(self, index):
        return self.layers[index]

    @property
    def layers(self) -> List[LayerWeights]:
        """Per layer (w_dil (2C, 3, Cp), b_dil (2C,), w_rs (2C or C, Cp),
        b_rs (2C or C,)): views of the stacked tensors."""
        return _layer_views(self.w_dil, self.b_dil, self.w_rs, self.b_rs, self.skip_only, self.C)

    @property
    def dtype(self) -> torch.dtype:
        return self.w_dil.dtype

    @property
    def device(self) -> torch.device:
        return self.w_dil.device


def _layer_views(w_dil, b_dil, w_rs, b_rs, skip_only, C) -> List[LayerWeights]:
    return [(w_dil[i], b_dil[i], w_rs[i, :C] if so else w_rs[i], b_rs[i, :C] if so else b_rs[i])
            for i, so in enumerate(skip_only)]


# launch arguments by (device, dtype, C, the stacked weights' addresses, the
# skip-only flags): they encode nothing but where the weights lie
_LAUNCH_ARGS_KEPT = 64
_launch_args_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
_launch_args_lock = threading.Lock()


def _launch_args(w_dil, b_dil, w_rs, b_rs, skip_only, C: int, Cp: int):
    """ctypes arrays of the per-layer device pointers and skip-only flags
    and, for bf16, the host buffer of the weights' tensor maps, for stacked
    weights in the kernel layout: built at the first launch on these
    addresses and kept (the last `_LAUNCH_ARGS_KEPT` weight sets)."""
    stacked = (w_dil, b_dil, w_rs, b_rs)
    key = (w_dil.device, w_dil.dtype, C, tuple(t.data_ptr() for t in stacked), tuple(skip_only))
    with _launch_args_lock:
        hit = _launch_args_cache.get(key)
        if hit is not None:
            _launch_args_cache.move_to_end(key)
            return hit
    n = len(skip_only)
    ptrs = [(ctypes.c_void_p * n)(*[t[i].data_ptr() for i in range(n)]) for t in stacked]
    flags = (ctypes.c_int * n)(*[int(so) for so in skip_only])
    maps = None
    if w_dil.dtype == torch.bfloat16:
        lib = kernel_lib.library()
        maps = torch.zeros((n, 2, _TENSOR_MAP_BYTES), dtype=torch.uint8)
        for i, so in enumerate(skip_only):
            kernel_lib.check(lib.mbexwn_wavenet_weight_maps(maps[i].data_ptr(), w_dil[i].data_ptr(),
                                                            w_rs[i].data_ptr(), C, Cp, C if so else 2 * C),
                             "wavenet_layer (tensor map of the weights)")
    args = (ptrs, flags, maps)
    with _launch_args_lock:
        _launch_args_cache[key] = args
        while len(_launch_args_cache) > _LAUNCH_ARGS_KEPT:
            _launch_args_cache.popitem(last=False)
    return args


StackWeights = Union[PackedStackWeights, Sequence[LayerWeights]]


def pack_stack_weights(layer_weights: Sequence[LayerWeights]) -> PackedStackWeights:
    """Check a stack's layers (w_dil (2C, 3, C), b_dil (2C,), w_rs (2C or C, C),
    b_rs, one dtype, one device), pad their reduction dimension to the
    kernel layout and stack them."""
    if not layer_weights:
        raise ValueError("pack_stack_weights: a stack needs at least one layer")
    w0 = layer_weights[0][0]
    C, Cp = w0.shape[-1], padded_channels(w0.shape[-1])
    skip_only = []
    for i, (wd, bd, wr, br) in enumerate(layer_weights):
        n_rs = wr.shape[0]
        expected = {"w_dil": (wd, (2 * C, 3, C)), "b_dil": (bd, (2 * C,)),
                    "w_rs": (wr, (n_rs if n_rs == C else 2 * C, C)), "b_rs": (br, (n_rs,))}
        for name, (t, shape) in expected.items():
            if t.device != w0.device or t.dtype != w0.dtype or tuple(t.shape) != shape:
                raise ValueError(f"pack_stack_weights: layer {i} {name} must be a {w0.dtype} tensor of shape {shape} "
                                 f"on {w0.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        skip_only.append(n_rs == C)

    def rows(t):  # a skip-only layer's C rows, zeros to 2C
        return F.pad(t, (0, 0) * (t.dim() - 1) + (0, C)) if t.shape[0] == C else t

    w_dil = torch.stack([_pad_columns(lw[0], Cp - C) for lw in layer_weights])
    b_dil = torch.stack([lw[1] for lw in layer_weights])
    w_rs = torch.stack([rows(_pad_columns(lw[2], Cp - C)) for lw in layer_weights])
    b_rs = torch.stack([rows(lw[3]) for lw in layer_weights])
    return PackedStackWeights(w_dil, b_dil, w_rs, b_rs, tuple(skip_only), C, Cp)


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
    """(B, T, C) x, (B, T, 2C) or per-layer (B, T, L, 2C) cond -> (B, T, C) fp32
    skip sum, in plain PyTorch (fp32 products of the operand-dtype values);
    `causal` shifts the taps to t-2d, t-d, t (the pad goes left).  Takes the
    layers as listed in the module docstring or packed, and x with C or Cp
    columns: it reads
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
    per_layer = cond.dim() == 4
    if per_layer and cond.shape[2] != len(layers):
        raise ValueError(f"wavenet_stack_plain: a per-layer cond of {cond.shape[2]} slabs for {len(layers)} layers")
    cond32 = None if per_layer else cond.float()
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    for i, ((wd, bd, wr, br), d) in enumerate(zip(layers, dils)):
        xp = F.pad(x.float(), (0, 0, 2 * d, 0) if causal else (0, 0, d, d))
        wd = wd[..., :C].float()
        y = (xp[:, :T] @ wd[:, 0].t() + xp[:, d : d + T] @ wd[:, 1].t() + xp[:, 2 * d : 2 * d + T] @ wd[:, 2].t()
             + bd.float() + (cond[:, :, i].float() if per_layer else cond32))
        g = gate(activation, y[..., :C], y[..., C:]).to(dtype)
        rs = g.float() @ wr[..., :C].float().t() + br.float()
        if rs.shape[-1] == 2 * C:
            x = (x.float() + rs[..., :C]).to(dtype)
            skip += rs[..., C:]
        else:
            skip += rs
    return skip


def _kernel_cond(cond: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """cond (B, T, 2C) or per-layer (B, T, L, 2C) as the kernel reads it, and
    the distance Ch between a slab's halves.  The bf16 kernel fetches each
    half with TMA, whose boxes start on 16-byte boundaries: where C is not a
    multiple of 8 (VOICE's 340) the halves are copied to columns 0 and Ch = C
    rounded up to 8, zeros between.  fp32, and bf16 at a multiple of 8
    (SPEECH's 320, WaveGlow's 256), take cond as it is (a copy only if its
    rows are not contiguous)."""
    lead, C = cond.shape[:-1], cond.shape[-1] // 2
    Ch = C if cond.dtype != torch.bfloat16 else -(-C // 8) * 8
    if Ch != C:
        cond = F.pad(cond.reshape(*lead, 2, C), (0, Ch - C)).view(*lead, 2 * Ch)
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
    """(B, T, C) x and (B, T, 2C) or per-layer (B, T, L, 2C) cond in the operand
    dtype (fp32 or bf16), weights as listed in the module docstring or packed by
    `pack_stack_weights` (a list is packed first) -> (B, T, C) fp32 skip
    sum; `causal` selects the taps t-2d, t-d, t in place of t-d, t, t+d.
    Calls the op `mbexwn::wavenet_stack`: on CUDA tensors the kernel: x is
    copied once into a zero-padded (B, T, Cp) buffer, the layers ping-pong
    between that and a second one, and one host call enqueues them all.
    CPU tensors take the plain version.  The op has no backward pass: with
    grad mode on, inputs that require grad raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"wavenet_stack: unsupported device {x.device}")
    p = layer_weights if isinstance(layer_weights, PackedStackWeights) else pack_stack_weights(layer_weights)
    return torch.ops.mbexwn.wavenet_stack(x, cond, p.w_dil, p.b_dil, p.w_rs, p.b_rs, [int(d) for d in dils],
                                          list(p.skip_only), activation, bool(causal))


@torch.library.custom_op("mbexwn::wavenet_stack", mutates_args=(), device_types="cpu")
def _wavenet_stack_op(x: torch.Tensor, cond: torch.Tensor, w_dil: torch.Tensor, b_dil: torch.Tensor,
                      w_rs: torch.Tensor, b_rs: torch.Tensor, dilations: List[int], skip_only: List[bool],
                      activation: str, causal: bool) -> torch.Tensor:
    """The op on CPU tensors: the plain version."""
    layers = _layer_views(w_dil, b_dil, w_rs, b_rs, skip_only, cond.shape[-1] // 2)
    return wavenet_stack_plain(x, cond, layers, dilations, activation, causal)


@_wavenet_stack_op.register_kernel("cuda")
def _wavenet_stack_op_cuda(x, cond, w_dil, b_dil, w_rs, b_rs, dilations, skip_only, activation, causal):
    """The op on CUDA tensors: the kernel, under the tensors' device."""
    if activation != "gtu":
        raise NotImplementedError(f"the CUDA kernel computes the gtu gate only, not {activation}; a stack "
                                  f"with another gate runs the layer loop (nn/wavenet.py WaveNetAE.route)")
    with kernel_lib.on_device(x.device):
        return _wavenet_stack_cuda(x, cond, (w_dil, b_dil, w_rs, b_rs), dilations, skip_only, causal)


@_wavenet_stack_op.register_fake
def _(x, cond, w_dil, b_dil, w_rs, b_rs, dilations, skip_only, activation, causal):
    C = cond.shape[-1] // 2
    return x.new_empty((x.shape[0], x.shape[1], C), dtype=torch.float32)


kernel_lib.no_backward(_wavenet_stack_op, "wavenet_layer")


def _wavenet_stack_cuda(x, cond, stacked, dils, skip_only, causal):
    """The op on CUDA tensors, under their device: the stacked weights in
    the kernel layout (`PackedStackWeights`)."""
    B, T, C = x.shape
    _check_kernel_dtype("wavenet_stack", x.dtype, C)
    Cp, n = padded_channels(C), len(skip_only)
    if n == 0:
        raise ValueError("wavenet_stack: a stack needs at least one layer")
    if len(dils) != n:
        raise ValueError(f"wavenet_stack: {len(dils)} dilations for {n} layers")
    for name, t, shape in zip(("w_dil", "b_dil", "w_rs", "b_rs"), stacked,
                              ((n, 2 * C, 3, Cp), (n, 2 * C), (n, 2 * C, Cp), (n, 2 * C))):
        _check_operand("wavenet_stack", f"{name} (the stacked kernel layout: pack_stack_weights)", t, shape,
                       x.dtype, x.device)
    per_layer = cond.dim() == 4
    _check_operand("wavenet_stack", "cond", cond, (B, T, n, 2 * C) if per_layer else (B, T, 2 * C), x.dtype, x.device,
                   contiguous=False)
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return skip
    # ping-pong buffers in the kernel layout; the caller's x is only read
    alloc = torch.empty if Cp == C else torch.zeros
    bufs = alloc((2, B, T, Cp), dtype=x.dtype, device=x.device)
    bufs[0, :, :, :C].copy_(x)
    ptrs, flags, maps = _launch_args(*stacked, skip_only, C, Cp)
    cond, Ch = _kernel_cond(cond)
    count = kernel_lib.library().mbexwn_wavenet_stack(
        _KERNEL_DTYPES[x.dtype], n, bufs[0].data_ptr(), bufs[1].data_ptr(), cond.data_ptr(), *ptrs,
        (ctypes.c_int * n)(*[int(d) for d in dils]), flags, None if maps is None else maps.data_ptr(),
        skip.data_ptr(), B, T, C, Cp, Ch, int(per_layer), int(causal), torch.cuda.current_stream(x.device).cuda_stream)
    kernel_lib.launches["wavenet_layer"] += kernel_lib.launched(count, "wavenet_layer")
    return skip
