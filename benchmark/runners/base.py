"""What the runners share: the F0 net's output hook, the reference, timing."""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from reference.mbexwn_ref import Reference, weights_path

DRAIN_S = 60.0  # how long a run waits past the window for the answers due in it


class F0Tap:
    """A forward hook on the program's F0 net (`model.block.pp_subnet`): the
    output of each call that `want(call index)` selects is kept, so the check
    can hold the F0 stage on its own and synthesise the reference from the
    program's F0 (reference/mbexwn_ref.py says why).  The hook does nothing
    else; it is removed before the check."""

    def __init__(self, model: torch.nn.Module):
        self.calls = 0
        self.want: Callable[[int], bool] = lambda k: False
        self.kept: Dict[int, torch.Tensor] = {}
        self.handle = model.block.pp_subnet.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        k = self.calls
        self.calls += 1
        if self.want(k):
            self.kept[k] = output

    def reset(self, want: Callable[[int], bool]) -> None:
        self.calls, self.want = 0, want

    def remove(self) -> None:
        self.handle.remove()

    def host(self) -> Dict[int, torch.Tensor]:
        """The kept outputs on the host (fp32), the device copies dropped."""
        out = {k: v.float().cpu() for k, v in self.kept.items()}
        self.kept = {}
        return out


def sleep_until(t: float) -> None:
    """Idle until perf_counter reaches t; a traced slice labels the wait."""
    if t <= time.perf_counter():
        return
    with torch.profiler.record_function("bench.idle_until_due"):
        _spin_until(t)


def _spin_until(t: float) -> None:
    while True:
        dt = t - time.perf_counter()
        if dt <= 0:
            return
        time.sleep(dt - 1e-3 if dt > 2e-3 else 0)


def p95_ms(latencies_s: List[float]) -> float:
    """The 95th percentile in ms; a summary (median, max, and the means of
    the first and last fifth in due order, which part when a backlog grows)
    goes to standard error."""
    if not latencies_s:
        raise ValueError("nothing was due in the window")
    ms = np.asarray(latencies_s) * 1e3
    fifth = max(1, len(ms) // 5)
    print(f"latency ms: n {len(ms)} p50 {np.median(ms):.2f} p95 {np.percentile(ms, 95):.2f} max {ms.max():.2f} "
          f"first fifth {ms[:fifth].mean():.2f} last fifth {ms[-fifth:].mean():.2f}", file=sys.stderr)
    return float(np.percentile(ms, 95))


class BaseRunner:
    """A runner runs one traffic mix against the program: `setup`, `start`
    (which sets `window_start`), `run_window`, `finish` (the answers due in
    the window), `end_to_end`, `release`, `compare`.  It counts `attempted`,
    `failed` and `missing` (due in the window, never answered)."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.config = ctx.config
        self.device = ctx.device
        self.pre = ctx.config["preprocess_config"]
        self.hop, self.sr, self.n_mels = self.pre["hop_size"], self.pre["sample_rate"], self.pre["mel_channels"]
        self.attempted = self.failed = self.missing = 0
        self.window_start = None
        self.tracer = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reference(self, **modes) -> Reference:
        return Reference(self.config, weights_path(self.config, self.ctx.root), self.device, **modes)

    def references(self, causal: bool = False):
        """(the reference the program is held to, what stands in the
        program's place: None for the program itself, or the reference in
        fp8 with `--control ref8`)."""
        ref = self.reference(causal=causal)
        if self.ctx.control != "ref8":
            return ref, None
        return ref, self.reference(causal=causal, subnet_mode="fp8", wn_mode="fp8")

    def slice_counts(self, t0: float, t1: float) -> Dict[str, float]:
        return {}

