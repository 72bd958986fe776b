"""Observability: profiling traces and the port's spans, NaN and finite
guards, the JSONL metrics stream, the architecture summary, the
control-signal dump and the analytic FLOP count.

Counterpart of the JAX package's observability.py:

- `profile_trace`: a `torch.profiler` trace of the host and the card,
  written where TensorBoard's profiler plugin or Perfetto opens it;
- `span`: a named range at a layer boundary of the port (the names below),
  recorded only while a `torch.profiler` records;
- `debug_nans` (a dispatch mode that raises at the first op whose output
  holds a NaN, the `mbexwn::` kernel ops included) and `check_finite`;
- `MetricsLogger`: the JSONL scalar stream;
- `model_summary`: per-stage shapes and parameter counts, counted on the
  JAX package's tree (`compat.params_io.params_to_jax`), so a model in the
  trainable form counts `v` and `g` as the JAX package does;
- `dump_controls`: F0, excitation, envelope and RMS of one synthesis;
- `synthesis_flops`: the JAX package's analytic FLOP count per call.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
from typing import Dict, Iterator

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode

from .compat.params_io import params_to_jax

# the port's spans, one per layer boundary, outermost first.  Serving and
# streaming are first in, first out, so the k-th dispatch (enqueue) of a
# trace pairs with its k-th collect wait (readback).
SERVING_DISPATCH = "mbexwn.serving.dispatch"  # a group: stack, copy in, the model's enqueue, copy out, event
SERVING_COLLECT_WAIT = "mbexwn.serving.collect_wait"  # the host's wait on a group's event
STREAM_ENQUEUE = "mbexwn.stream.enqueue"  # a live chunk: copy in, carry arithmetic, the model's enqueue
STREAM_READBACK = "mbexwn.stream.readback"  # a live chunk's blocking copy to the host
STREAM_REPLAY = "mbexwn.stream.replay"  # inside an enqueue: the launch of a chunk shape's captured graph
MODEL_NORMMEL = "mbexwn.model.normmel"  # RMS normalisation of the mel
MODEL_F0_NET = "mbexwn.model.f0_net"
MODEL_EXCITATION = "mbexwn.model.excitation"  # oscillator, fold to the WaveNet rate, noise channel
MODEL_WAVENET = "mbexwn.model.wavenet."  # + the block's name: one WaveNet block
MODEL_POST_PQMF = "mbexwn.model.post_pqmf"  # post net, multiband gains, PQMF synthesis
MODEL_ENVELOPE = "mbexwn.model.envelope"  # envelope (or multiband gain) subnet, STFT, filter, iSTFT
WAVEGLOW_UPSAMPLE = "mbexwn.model.waveglow.upsample"  # WaveGlow's upsampler, its trim, the group unfold, the cast
WAVEGLOW_COUPLING = "mbexwn.model.waveglow.coupling"  # WaveGlow: z, each flow's coupling inverse, W^-1, early z
# WaveGlow's WNs take MODEL_WAVENET + "flow<k>"

_NO_SPAN = contextlib.nullcontext()
# a span's range: an op-scope record (a host event, like an aten op's).  A
# user-scope range (`torch.profiler.record_function`) would also make the
# profiler add a device-side range over the kernels launched inside it,
# which a reader of the trace's device activity counts as device work.
_record_function = torch._C._profiler._RecordFunctionFast


def _leaves_with_path(tree, path: str = ""):
    """(path, leaf) of a nested dict / list / tuple, the path spelled as the
    JAX package's `keystr` spells it (['key'][0])."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the scope (host and, where there is one, the card) and write
    a Chrome trace (`<worker>.<time>.pt.trace.json`) into `log_dir`, which
    TensorBoard's profiler plugin or Perfetto opens.  Yields the profiler
    (`key_averages()`)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [a for a in (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def span(name: str):
    """A context manager that marks the scope as `name` in a `torch.profiler`
    trace: while a profiler records, a host range named `name` on the clock
    of the device events it launches (a `profile_trace` shows it above
    them); otherwise (and while `torch.export` or `torch.compile` traces,
    which would put the profiler's ops into the graph) a shared no-op, one
    flag check."""
    if _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling():
        return _record_function(name)
    return _NO_SPAN


# the innermost debug_nans scope's flag (None outside every scope)
_debug_nans = contextvars.ContextVar("mbexwn_debug_nans", default=None)


class _NaNCheck(TorchDispatchMode):
    """Raises FloatingPointError after the first op whose floating output
    holds a NaN, naming the op, while the innermost scope is enabled."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _debug_nans.get():
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, t in enumerate(outs):
                if torch.is_tensor(t) and (t.is_floating_point() or t.is_complex()) and bool(torch.isnan(t).any()):
                    raise FloatingPointError(f"debug_nans: {func} produced a NaN (output {i}, shape "
                                             f"{tuple(t.shape)})")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Within the scope, every op's floating output is checked for NaN (a
    host read each op, so the card waits for every op) and the first NaN
    raises FloatingPointError naming the op: an aten op, or one of the
    `mbexwn::` kernel ops.  Scopes nest as the JAX package's flag does: the
    innermost one's `enable` holds, and leaving a scope restores the
    outer one's."""
    token = _debug_nans.set(enable)
    try:
        if enable:
            with _NaNCheck():
                yield
        else:
            yield
    finally:
        _debug_nans.reset(token)


def check_finite(tree, name: str = "value") -> None:
    """Host-side finite check over a nested dict / list of tensors or arrays
    (a stage-boundary guard): raises FloatingPointError naming the first
    leaf with a non-finite value."""
    for path, leaf in _leaves_with_path(tree):
        arr = leaf.detach().float().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(f"{name}{path}: {bad} non-finite values")


class MetricsLogger:
    """Append-only JSONL scalar stream, one record per step: `step`, `time`
    (seconds since the logger was made) and every metric that converts to a
    float."""

    def __init__(self, log_dir: str, name: str = "metrics"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict) -> None:
        rec = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError, RuntimeError):
                pass
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()


def _count(flat: Dict[str, np.ndarray], prefix: str = "") -> int:
    return int(sum(np.prod(v.shape) for k, v in flat.items() if k.startswith(prefix)))


def model_summary(model, T_mel: int = 64, print_fn=print) -> None:
    """Architecture summary with per-stage shapes and parameter counts, the
    lines the JAX package's `model_summary` prints for the same config."""
    blk = model.block
    flat = params_to_jax(blk.state_dict())
    stp = blk.spect_to_pulse_upsampling_factor
    hop = blk.spect_hop_size
    print_fn(f"Model {model.name}")
    print_fn("---------------------------------------")
    print_fn(f"{'Input mel':28s} -> (B, {T_mel}, {blk.mel_channels})")
    if blk.pp_subnet is not None:
        print_fn(f"{'PulseParameterGenerator':28s} -> (B, {T_mel * stp}) ## {_count(flat, 'pp_subnet/')}")
    print_fn(f"{'PulseWavetable':28s} -> {tuple(flat['wavetables'].shape)} (F0 grid {len(blk.wavetable.F0_list)})")
    t = T_mel * stp // blk.wn_fold_factor
    for name in blk.block_names:
        bl = getattr(blk, name)
        t_out = bl.out_length(t)
        print_fn(f"  {name:26s} -> (B, {t_out}, {bl.wavenet.end.filters}) ## {_count(flat, name + '/')}")
        t = t_out
    print_fn(f"  {'wn_post_net':26s} -> (B, {t}, {blk.mb_factor}) ## {_count(flat, 'wn_post_net/')}")
    print_fn(f"{'PQMF synthesis':28s} -> (B, {T_mel * hop})")
    if blk.ps_subnet is not None:
        print_fn(f"{'PulseSpectrumGenerator':28s} -> (B, {T_mel}, {blk.ps_max_ceps_coefs}) "
                 f"## {_count(flat, 'ps_subnet/')}")
    print_fn(f"{'STFT filter + iSTFT':28s} -> (B, {T_mel * hop})")
    print_fn(f"{'total params':28s} ## {_count(flat)}")
    print_fn("---------------------------------------")


def dump_controls(path: str, model, mel, noise=None) -> Dict:
    """Debug dump of the control signals of one synthesis (F0, excitation,
    |envelope|, upsampled RMS) with `compat.iovar.save_var`, under the JAX
    package's keys; `mel` (B, T_mel, C) log-mel, `noise` the noise channel
    (`MBExWN.fold_pulse_channels`).  Returns the dict."""
    from .compat.iovar import save_var

    device = model.block.wavetables.device
    mel = torch.as_tensor(np.asarray(mel, np.float32) if not torch.is_tensor(mel) else mel).to(device)
    noise = None if noise is None else torch.as_tensor(noise).to(device, torch.float32)
    with torch.no_grad():
        F0, excitation, specenv, rms = model.infer_components(mel, noise=noise)
    data = {
        "pulse_frequency": F0.cpu().numpy(),
        "pulse_signal": excitation.cpu().numpy(),
        "PulseFilterSpectrum": torch.abs(specenv).cpu().numpy(),
    }
    if rms is not None:
        data["upsampled_rms"] = rms.cpu().numpy()
    save_var(path, data)
    return data


def synthesis_flops(model, T_mel: int = 1, batch: int = 1) -> Dict:
    """Analytic FLOP count per synthesis call, the JAX package's
    `synthesis_flops` (the same terms and numbers): subnets, WaveNet stacks,
    post net, PQMF, the oscillator's tent cross-fade and the rDFTs of the
    envelope and the STFT/iSTFT.  A WaveGlow model: `waveglow_flops`."""
    if not hasattr(model, "block"):
        return waveglow_flops(model, T_mel, batch)
    blk = model.block
    hop = blk.spect_hop_size
    t12k = T_mel * blk.spect_to_pulse_upsampling_factor

    def conv_flops(t, cin, cout, k):
        return 2 * t * cin * cout * k

    def seq_flops(seq, t, cin):
        f = 0
        for layer in seq.children():
            name = type(layer).__name__
            if name == "Conv1DWeightNorm":
                f += conv_flops(layer.out_length(t), cin, layer.filters, layer.kernel_size)
                cin = layer.filters
            elif name == "Conv1DUpDownSample":
                f += conv_flops(t, cin, layer.filters, layer.kernel_size)
                cin = layer.out_filters
            t = layer.out_length(t)
        return f

    breakdown = {}
    if blk.pp_subnet is not None:
        breakdown["pp_subnet"] = seq_flops(blk.pp_subnet, T_mel, blk.mel_channels)
    if blk.ps_subnet is not None:
        breakdown["ps_subnet"] = seq_flops(blk.ps_subnet, T_mel, blk.mel_channels)
    wn = 0
    t = t12k // blk.wn_fold_factor
    for name in blk.block_names:
        bl = getattr(blk, name)
        w = bl.wavenet
        n_out = w.end.filters
        wn += conv_flops(t, blk.wn_in_channels, w.n_channels, 1)  # start
        for i in range(w.n_layers):  # the dilated conv (kernel 3) and the res/skip 1x1 (skip only last)
            wn += conv_flops(t, w.n_channels, 2 * w.n_channels, 3)
            wn += conv_flops(t, w.n_channels, (2 if i < w.n_layers - 1 else 1) * w.n_channels, 1)
        wn += conv_flops(t, w.n_channels, n_out, 1)  # end
        wn += conv_flops(T_mel, blk.mel_channels, 2 * w.n_channels, w.cond.kernel_size)
        if bl.up_down is not None:
            wn += conv_flops(t, n_out, bl.up_down.filters, 3)
            t = bl.out_length(t)
    breakdown["wavenet"] = wn
    breakdown["post_pqmf"] = (conv_flops(t, blk.wn_post_net.filters, blk.mb_factor, 1)
                              + conv_flops(T_mel * hop, blk.mb_factor, 1, blk.multi_band_config["taps"] + 1))
    breakdown["oscillator"] = 2 * t12k * blk.wavetable.n_wavetable * len(blk.wavetable.F0_list)
    K = blk.fft_size // 2 + 1
    breakdown["envelope_rdft"] = 2 * T_mel * blk.ps_max_ceps_coefs * K * 2
    breakdown["stft_istft"] = 2 * (T_mel + 2) * blk.stft_win_size * K * 2 * 2

    total = batch * sum(breakdown.values())
    audio_seconds = batch * T_mel * hop / blk.sample_rate
    return {
        "flops_per_call": total,
        "flops_per_audio_second": total / audio_seconds,
        "breakdown": {k: batch * v for k, v in breakdown.items()},
    }


def waveglow_flops(model, T_mel: int = 1, batch: int = 1) -> Dict:
    """Analytic FLOP count of one WaveGlow synthesis (models/waveglow.py),
    2 per multiply-add: the transposed-conv upsampler (every input frame
    against the whole kernel), and per flow at T_mel * hop / n_group rows its
    WN (start, the 1-wide per-layer cond conv, 16 C^2 a row and layer and
    14 C^2 for the skip-only last, end), the coupling's subtract, exp and
    divide (3 a row and channel) and W^-1."""
    G, hop = model.n_group, model.spect_hop_size
    rows = T_mel * hop // G
    up = model.upsample
    breakdown = {"upsample": 2 * T_mel * up.weight.shape[0] * up.weight.shape[1] * up.kernel_size,
                 "wavenet_layers": 0, "wavenet_cond": 0, "wavenet_start_end": 0, "coupling": 0}
    for wn, inv in zip(model.WN, model.convinv):
        C, L, h = wn.n_channels, wn.n_layers, wn.end.filters // 2
        breakdown["wavenet_layers"] += rows * C * C * (16 * (L - 1) + 14)
        breakdown["wavenet_cond"] += 2 * rows * wn.cond.in_channels * wn.cond.filters
        breakdown["wavenet_start_end"] += 2 * rows * h * C + 2 * rows * C * 2 * h
        c = inv.weight.shape[0]
        breakdown["coupling"] += 3 * rows * h + 2 * rows * c * c
    total = batch * sum(breakdown.values())
    return {"flops_per_call": total, "flops_per_audio_second": total / (batch * T_mel * hop / model.sample_rate),
            "breakdown": {k: batch * v for k, v in breakdown.items()}}
