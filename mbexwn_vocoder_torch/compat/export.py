"""AOT model export: a synthesis program saved with `torch.export`.

Counterpart of the JAX package's compat/export.py.  A model is exported as
a self-contained program -- parameters baked in -- that runs later with
this package's kernel ops alone: no model classes, no config system, no
weight files.  `load_exported` and `synth_from_artifact` import the op
registrations (ops/wavenet_stack.py, ops/oscillator.py, ops/post_pqmf.py)
and nothing of `models`, `nn`, `config` or `mel_inverter`.

What is exported: `infer(mel, synth_length=T_mel*hop)` at a fixed
(batch, T_mel), traced by `torch.export.export(strict=False)` under
`no_grad`, from a copy of the model whose parameters are frozen and whose
WaveNet stacks hold their weights in the form their route reads (packed in
the kernel layout, or quantized in the int8 mode;
`WaveNetAE.freeze_stack_`), so a call does not make them again.  Each
stack is one `mbexwn::wavenet_stack` node, the oscillator one
`mbexwn::oscillate` node and, in a program for the card, the post net and
PQMF synthesis one `mbexwn::post_pqmf` node (a CPU program holds the
stage's plain ops); their CUDA implementations build the kernels' launch
arguments from wherever the loaded weights lie.

- Noise: a `torch.Generator` cannot be exported, so the program holds the
  draw the serving classes make, one (B, L, 1) standard normal from a
  generator seeded 0 on the program's device: the program equals
  `MELInverter.synth_from_mel` (batch 1) and `BatchSynthesizer` /
  `PipelinedSynthesizer` (a group of B) at the same bucket.
- Precision: the fp32 policy (`ops.precision.exact_fp32`) is a set of
  global flags that no graph records, so the loaded callable sets it
  itself.  The compute dtypes in force at export time (`MBEXWN_WN_DTYPE`,
  `MBEXWN_SUBNET_DTYPE` or the config) are baked in and recorded in meta,
  and so is the int8 mode (`MBEXWN_WN_QUANT=int8` at export time): its
  stacks are frozen with their quantized weights (int8, scales, fp32
  biases), and the program quantizes the activations and runs the int8
  products (ops/quant.py) on every call.
- Platforms: one program per platform named (`cuda`, `cpu`), the model's
  device by default; loading on a platform the artifact lacks raises.

File format: `_MAGIC`, the length of the meta block (8 bytes, little
endian), the meta block (JSON: batch_size, T_mel, mel_channels, hop_size,
sample_rate, platforms, program_bytes, wn_dtype, subnet_dtype, wn_quant,
noise, torch), then each platform's `torch.export.save` bytes in the order of
`platforms`.
"""
from __future__ import annotations

import copy
import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import oscillator, post_pqmf, wavenet_stack  # noqa: F401  (registers the mbexwn:: ops)
from ..ops.precision import exact_fp32
from ..ops.quant import wn_quant_mode
from ..platform import resolve_device

_MAGIC = b"MBEXWN_TORCH_AOT1\n"
_JAX_MAGIC = b"MBEXWN_AOT1\n"  # the JAX package's StableHLO artifacts
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


class _Synthesis(torch.nn.Module):
    """`infer` at one length, with the serving classes' noise draw held as
    a buffer."""

    def __init__(self, model, noise: Optional[torch.Tensor], synth_length: int):
        super().__init__()
        self.model = model
        self.synth_length = synth_length
        self.register_buffer("noise", noise)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model.infer(mel, synth_length=self.synth_length, noise=self.noise)


def _serving_copy(model, device: torch.device):
    """A frozen copy of `model` on `device`: eval mode, no parameter
    requiring grad, every WaveNet stack on the kernel's or the int8 route
    frozen in its compute dtype (`freeze_stack_`).  A stack on the layer
    loop keeps its convs, and the program computes that route from them."""
    from ..nn.wavenet import WaveNetAE

    program = copy.deepcopy(model).to(device).eval()
    program.fold_()
    program.requires_grad_(False)
    for m in program.modules():
        if isinstance(m, WaveNetAE) and m.route() != "layers":
            m.freeze_stack_(m.compute_dtype or torch.float32)
    return program


def export_synthesis(model, T_mel: int, batch_size: int = 1, platforms: Optional[Sequence[str]] = None) -> bytes:
    """Serialize `model.infer` (a `PaNWaveNet`) at a fixed (batch, T_mel)
    shape, one program per platform (default: the model's device)."""
    blk = model.block
    hop, mel_channels = model.spect_hop_size, model.mel_channels
    names = [_platform(p) for p in (platforms or [blk.wavetables.device.type])]
    programs = []
    for name in names:
        device = resolve_device(name)
        program = _serving_copy(model, device)
        noise = program.noise(batch_size, T_mel, device)
        mel = torch.zeros((batch_size, T_mel, mel_channels), device=device)
        with torch.no_grad(), exact_fp32():
            exported = torch.export.export(_Synthesis(program, noise, T_mel * hop), (mel,), strict=False)
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        programs.append(buf.getvalue())
    meta = {
        "batch_size": batch_size,
        "T_mel": T_mel,
        "mel_channels": mel_channels,
        "hop_size": hop,
        "sample_rate": model.sample_rate,
        "platforms": names,
        "program_bytes": [len(p) for p in programs],
        "wn_dtype": str(blk.wn_compute_dtype or torch.float32).replace("torch.", ""),
        "subnet_dtype": str(blk.subnet_compute_dtype or torch.float32).replace("torch.", ""),
        "wn_quant": wn_quant_mode() or None,
        "noise": "normal (B, L, 1), generator seeded 0" if blk.pp_mod_subnet_noise_channel_sigma else None,
        "torch": torch.__version__,
    }
    meta_blob = json.dumps(meta).encode()
    return _MAGIC + len(meta_blob).to_bytes(8, "little") + meta_blob + b"".join(programs)


def _platform(name: str) -> str:
    if name not in _PLATFORMS:
        raise ValueError(f"unknown platform {name!r}: expected one of {sorted(_PLATFORMS)}")
    return _PLATFORMS[name]


def _read_meta(blob: bytes):
    """(meta, offset of the first program) of an artifact's bytes."""
    if blob.startswith(_JAX_MAGIC):
        raise ValueError("this is an artifact of the JAX package (StableHLO from jax.export); load it with "
                         "mbexwn_vocoder_tpu.compat.export.load_exported")
    if not blob.startswith(_MAGIC):
        raise ValueError("not an MBExWN PyTorch AOT artifact")
    off = len(_MAGIC)
    n = int.from_bytes(blob[off: off + 8], "little")
    try:
        meta = json.loads(blob[off + 8: off + 8 + n].decode())
        if len(meta["platforms"]) != len(meta["program_bytes"]):
            raise ValueError("one program size per platform")
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise ValueError(f"malformed MBExWN PyTorch AOT artifact: {e}") from None
    return meta, off + 8 + n


def load_exported(blob, device="cuda"):
    """Deserialize an artifact (bytes, or a path to one) -> (callable
    mel (B, T_mel, mel_channels) -> waveform (B, T_mel*hop) on `device`,
    metadata dict).  The callable runs under `no_grad` and the fp32
    policy."""
    if isinstance(blob, (str, os.PathLike)):
        with open(blob, "rb") as f:
            blob = f.read()
    meta, start = _read_meta(blob)
    sizes = dict(zip(meta["platforms"], meta["program_bytes"]))
    device = torch.device(device)
    if device.type not in sizes:
        raise ValueError(f"the artifact holds programs for {meta['platforms']}, not for {device.type}")
    device = resolve_device(device)
    for name in meta["platforms"]:
        if name == device.type:
            break
        start += sizes[name]
    program = torch.export.load(io.BytesIO(blob[start: start + sizes[device.type]])).module()
    shape = (meta["batch_size"], meta["T_mel"], meta["mel_channels"])

    def call(mell):
        mel = torch.as_tensor(np.asarray(mell, dtype=np.float32) if not torch.is_tensor(mell) else mell)
        if tuple(mel.shape) != shape:
            raise ValueError(f"the artifact takes a mel of shape {shape}, got {tuple(mel.shape)}")
        with torch.no_grad(), exact_fp32():
            return program(mel.to(device, torch.float32))

    return call, meta


def export_model_dir(model_dir_or_id: str, out_path: str, T_mel: int, batch_size: int = 1,
                     platforms: Optional[Sequence[str]] = None, verbose: bool = False) -> dict:
    """Load a model directory / registry id and write the AOT artifact.  The
    model is loaded on the first platform named, or on the device
    `MBEXWN_PLATFORM` names (the card unless it says cpu)."""
    from ..mel_inverter import MELInverter
    from ..platform import platform_device

    device = _platform(platforms[0]) if platforms else platform_device()
    inv = MELInverter(model_dir_or_id, verbose=verbose, length_buckets=(T_mel,), device=device)
    blob = export_synthesis(inv.model, T_mel=T_mel, batch_size=batch_size, platforms=platforms)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(blob)
    meta, _ = _read_meta(blob)
    meta["bytes"] = len(blob)
    return meta


def synth_from_artifact(path: str, mell, device="cuda") -> np.ndarray:
    """One-call serving helper: load the artifact, run it on `device`,
    return the waveform (B, T_mel*hop)."""
    call, _ = load_exported(path, device=device)
    return call(mell).cpu().numpy()
