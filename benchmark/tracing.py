"""The traced slice of a run and its reduction.

A `--trace 1` run profiles a steady slice of its window with
`torch.profiler` (CPU and CUDA activities, input shapes), keeps the events
in memory, writes no trace file, and reduces them here to one `Trace`:
the device's busy time (the union of its kernel, copy and set intervals),
device time attributed to the CPU ops that launched it (every op on the
stack at the launch), the shapes of the kernel ops' calls, the host's
launch calls, and the longest device idle gaps with the host op running
at their start.
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

LAUNCH_RE = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchCooperativeKernel|LaunchKernelEx|GraphLaunch)")
SHAPED_OPS = ("mbexwn::wavenet_stack", "mbexwn::oscillate")


@dataclass
class Trace:
    window_s: float  # host clock from the profiler's start to its stop
    busy_s: float  # union of device intervals
    n_device: int
    launch_calls: int
    op_device_s: Dict[str, float]  # device seconds under each CPU op name (inclusive)
    top_device_ops: List[Tuple[str, float]]  # by the innermost op that launched them
    idle_gaps: List[Tuple[str, float]]
    op_shapes: Dict[str, List[list]] = field(default_factory=dict)  # input shapes of each SHAPED_OPS call
    t0: float = 0.0  # host perf_counter at the profiler's start
    t1: float = 0.0


class Tracer:
    """Starts the profiler `lead_s` after the window opens and stops it
    `span_s` later; a runner calls `poll()` from its loop.  With `enabled`
    false every call is a no-op."""

    def __init__(self, enabled: bool, lead_s: float, span_s: float, device: torch.device):
        self.enabled, self.lead_s, self.span_s, self.device = enabled, lead_s, span_s, device
        self.prof = None
        self.t0 = self.t1 = None
        self.done = False
        self.start_at = self.stop_at = None

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start loads
        and initialises CUPTI, which would otherwise fall into the window."""
        if not self.enabled:
            return
        with self._profile():
            torch.ones(8, device=self.device).sum().item()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        return profile(activities=acts, record_shapes=True)

    def arm(self, window_start: float) -> None:
        self.start_at = window_start + self.lead_s
        self.stop_at = self.start_at + self.span_s

    def poll(self, now: Optional[float] = None) -> None:
        if not self.enabled or self.done or self.start_at is None:
            return
        now = time.perf_counter() if now is None else now
        if self.prof is None and now >= self.start_at:
            self.prof = self._profile()
            self.prof.__enter__()
            self.t0 = time.perf_counter()
            self.stop_at = self.t0 + self.span_s
        elif self.prof is not None and now >= self.stop_at:
            self.stop()

    def stop(self) -> None:
        """Stop once the work launched in the slice has finished on the device."""
        if self.prof is None or self.done:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.done = True

    def reduce(self) -> Optional[Trace]:
        if not self.done:
            return None
        return reduce_events(self.prof.profiler.kineto_results.events(), self.t1 - self.t0, self.t0, self.t1)


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The gaps (start, end) between the merged intervals, in time order."""
    gaps, cur_e = [], None
    for s, e in sorted(spans):
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return gaps


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def reduce_events(events, window_s: float, t0: float = 0.0, t1: float = 0.0, top: int = 10) -> Trace:
    """Kineto events of one profiled slice -> `Trace`.  Times in ns."""
    device, launches, ops = [], [], []
    for ev in events:
        if _is_device(ev):
            device.append(ev)
        elif LAUNCH_RE.match(ev.name()):
            launches.append(ev)
        elif ev.device_type() == torch.autograd.DeviceType.CPU and ev.duration_ns() >= 0:
            ops.append(ev)
    spans = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in device]
    busy_s = union_seconds(spans) / 1e9

    # the CPU ops on each thread, for the stack of ops at each launch
    by_thread: Dict[int, list] = {}
    op_shapes: Dict[str, List[list]] = {}
    for ev in ops:
        by_thread.setdefault(ev.start_thread_id(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                                                                ev.name()))
        if ev.name() in SHAPED_OPS:
            op_shapes.setdefault(ev.name(), []).append([list(s) for s in ev.shapes()])
    starts = {}
    for tid, lst in by_thread.items():
        lst.sort(key=lambda x: (x[0], -x[1]))
        starts[tid] = [s for s, _, _ in lst]

    def stack_at(tid: int, t: int) -> List[str]:
        """Names of the ops on thread tid that enclose time t, outermost first
        (every op that starts at or before t is scanned back from there;
        op nesting keeps this short in practice)."""
        lst = by_thread.get(tid)
        if not lst:
            return []
        i = bisect.bisect_right(starts[tid], t)
        out = [name for s, e, name in lst[max(0, i - 256): i] if e >= t]
        return out

    launch_stack = {}
    for ev in launches:
        launch_stack[ev.correlation_id()] = stack_at(ev.start_thread_id(), ev.start_ns())
    op_device_ns: Dict[str, float] = {}
    by_innermost: Dict[str, float] = {}
    for ev in device:
        stack = launch_stack.get(ev.linked_correlation_id())
        if stack is None:
            stack = launch_stack.get(ev.correlation_id())
        dur = ev.duration_ns()
        if stack is None:
            by_innermost[ev.name()[:80]] = by_innermost.get(ev.name()[:80], 0.0) + dur
            continue
        for name in set(stack):
            op_device_ns[name] = op_device_ns.get(name, 0.0) + dur
        inner = stack[-1] if stack else ev.name()[:80]
        by_innermost[inner] = by_innermost.get(inner, 0.0) + dur

    # the longest idle gaps, labelled by the innermost host op at their start
    main_tid = max(by_thread, key=lambda k: len(by_thread[k])) if by_thread else None
    gaps = sorted(idle_gaps(spans), key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for s, e in gaps:
        stack = stack_at(main_tid, s) if main_tid is not None else []
        labelled.append((stack[-1] if stack else "host (no op)", (e - s) / 1e9))
    return Trace(window_s=window_s, busy_s=busy_s, n_device=len(device), launch_calls=len(launches),
                 op_device_s={k: v / 1e9 for k, v in op_device_ns.items()},
                 top_device_ops=[(k, v / 1e9) for k, v in sorted(by_innermost.items(), key=lambda kv: -kv[1])[:top]],
                 idle_gaps=labelled, op_shapes=op_shapes, t0=t0, t1=t1)
