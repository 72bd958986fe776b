"""Observability of a training run: a finite-value guard, the JSONL metrics
stream and the architecture summary.

Counterpart of `check_finite`, `MetricsLogger` and `model_summary` of the
JAX package's observability.py (the rest of that module, the profiler
context, the NaN-debug scope, the control dump and the FLOP count, is not
ported: ROADMAP.md queue 1, item 13).  `model_summary` counts the
parameters of the JAX package's tree (`compat.params_io.params_to_jax`), so
a model in the trainable form counts `v` and `g` as the JAX package does.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from .compat.params_io import params_to_jax


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
    t = T_mel * stp // blk.pulse_channels
    for name in blk.block_names:
        bl = getattr(blk, name)
        t_out = bl.out_length(t)
        print_fn(f"  {name:26s} -> (B, {t_out}, {bl.wavenet.end.filters}) ## {_count(flat, name + '/')}")
        t = t_out
    print_fn(f"  {'wn_post_net':26s} -> (B, {t}, {blk.mb_factor}) ## {_count(flat, 'wn_post_net/')}")
    print_fn(f"{'PQMF synthesis':28s} -> (B, {T_mel * hop})")
    print_fn(f"{'PulseSpectrumGenerator':28s} -> (B, {T_mel}, {blk.ps_max_ceps_coefs}) ## {_count(flat, 'ps_subnet/')}")
    print_fn(f"{'STFT filter + iSTFT':28s} -> (B, {T_mel * hop})")
    print_fn(f"{'total params':28s} ## {_count(flat)}")
    print_fn("---------------------------------------")
