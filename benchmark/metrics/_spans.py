"""What the span readers share (not a metric: the harness reads only the
files that BENCHMARK.json names): the traced slice's raw events reduced,
once per run, to the port's spans and the device time launched under them.

- host spans: CPU events named `mbexwn.*` (the program's
  `observability.span` ranges), with the `mbexwn::` kernel ops beside them
  for the breakdown, on the thread that ran them;
- device intervals: every kernel, copy and set on the card (a profiler's
  device-side copy of a host range, which carries its name, is none);
- launch attribution: a device event is linked to the runtime call that
  launched it by correlation id (as `tracing.reduce_events` links them),
  and goes to every span that encloses that call's start on the launching
  thread, by interval containment over the whole slice.

A program without spans (one that predates them) gives no reduction, and
its readers return None.
"""
from __future__ import annotations

import re
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import tracing

SPAN = "mbexwn."
HOST_PREFIXES = (SPAN, "mbexwn::")
RUNTIME_RE = re.compile(r"^cu(da)?[A-Z]")  # runtime and driver calls: launches, copies, sets
WAVENET = "mbexwn.model.wavenet."
OTHER_STAGES = ("mbexwn.model.normmel", "mbexwn.model.f0_net", "mbexwn.model.excitation",
                "mbexwn.model.post_pqmf", "mbexwn.model.envelope")
K1_OP = "mbexwn::wavenet_stack"

Interval = Tuple[int, int]


@dataclass
class Spans:
    host: Dict[str, List[Interval]]  # each span name's (start, end) in ns, every thread
    device: List[Interval]  # every device event's (start, end)
    device_ns: Dict[FrozenSet[str], int]  # device ns by the set of host names enclosing the launch

    def device_ns_under(self, pred: Callable[[str], bool]) -> int:
        """Device ns launched under at least one host name that `pred` accepts."""
        return sum(ns for names, ns in self.device_ns.items() if any(pred(n) for n in names))

    def total_device_ns(self) -> int:
        return sum(self.device_ns.values())


def merge(intervals: List[Interval]) -> List[Interval]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_ns(spans: Spans, name: str) -> int:
    """Device idle time (no device event running) inside the union of the
    host spans `name`."""
    host = merge(spans.host.get(name, []))
    return sum(e - s for s, e in host) - overlap_ns(host, merge(spans.device))


def _enclosing(intervals: List[Tuple[int, int, str]], points: List[Tuple[int, int]]) -> Dict[int, FrozenSet[str]]:
    """For each (time, key) point, the names of the intervals (start, end,
    name) that enclose it, ends included: a sweep over one thread."""
    marks = [(s, 0, name) for s, _, name in intervals] + [(e, 2, name) for _, e, name in intervals]
    marks += [(t, 1, key) for t, key in points]
    marks.sort(key=lambda m: (m[0], m[1]))
    open_names: Counter = Counter()
    current: FrozenSet[str] = frozenset()
    changed = False
    out = {}
    for _, kind, what in marks:
        if kind == 1:
            if changed:
                current, changed = frozenset(n for n, c in open_names.items() if c > 0), False
            out[what] = current
        else:
            open_names[what] += 1 if kind == 0 else -1
            changed = True
    return out


def reduce_spans(events) -> Optional[Spans]:
    """Kineto events of one slice -> `Spans`, or None where the slice holds
    no `mbexwn.` span."""
    device, calls = [], {}
    host_by_thread: Dict[int, List[Tuple[int, int, str]]] = {}
    for ev in events:
        name = ev.name()
        if tracing._is_device(ev):
            if not name.startswith(HOST_PREFIXES):  # a device-side copy of a host range is no device work
                device.append(ev)
            continue
        if name.startswith(HOST_PREFIXES) and ev.duration_ns() >= 0:
            s = ev.start_ns()
            host_by_thread.setdefault(ev.start_thread_id(), []).append((s, s + ev.duration_ns(), name))
        elif RUNTIME_RE.match(name):
            calls.setdefault(ev.start_thread_id(), []).append((ev.start_ns(), ev.correlation_id()))
    host: Dict[str, List[Interval]] = {}
    for lst in host_by_thread.values():
        for s, e, name in lst:
            host.setdefault(name, []).append((s, e))
    if not any(name.startswith(SPAN) for name in host):
        return None
    by_corr: Dict[int, FrozenSet[str]] = {}
    for tid, points in calls.items():
        by_corr.update(_enclosing(host_by_thread.get(tid, []), points))
    device_ns: Dict[FrozenSet[str], int] = {}
    intervals = []
    for ev in device:
        names = by_corr.get(ev.linked_correlation_id())
        if names is None:
            names = by_corr.get(ev.correlation_id(), frozenset())
        dur = ev.duration_ns()
        device_ns[names] = device_ns.get(names, 0) + dur
        intervals.append((ev.start_ns(), ev.start_ns() + dur))
    return Spans(host=host, device=intervals, device_ns=device_ns)


def _report(sp: Spans) -> None:
    """One line on standard error: the share of device time launched under
    a span, device ms by span, K1's device ms by WaveNet block, and the
    host spans' counts and mean ms."""
    total = sp.total_device_ns()
    covered = sp.device_ns_under(lambda n: n.startswith(SPAN))
    names = sorted(n for n in sp.host if n.startswith(SPAN))
    by_span = {n: round(sp.device_ns_under(lambda m, n=n: m == n) / 1e6, 3) for n in names}
    k1 = {n[len(WAVENET):]: round(sum(ns for s, ns in sp.device_ns.items() if n in s and K1_OP in s) / 1e6, 3)
          for n in names if n.startswith(WAVENET)}
    host = {n: [len(sp.host[n]), round(sum(e - s for s, e in sp.host[n]) / len(sp.host[n]) / 1e6, 4)]
            for n in names}
    share = f"{100.0 * covered / total:.3f} %" if total else "no device time"
    print(f"spans: device time launched under an {SPAN} span {covered / 1e9:.6f} of {total / 1e9:.6f} s ({share}); "
          f"device ms by span {by_span}; K1 device ms by block {k1}; host spans [count, mean ms] {host}",
          file=sys.stderr)


def spans_of(run) -> Optional[Spans]:
    """The run's reduction, made on the first call and kept on `run`."""
    if not hasattr(run, "spans"):
        prof = getattr(getattr(run.runner, "tracer", None), "prof", None)
        run.spans = None if prof is None else reduce_spans(prof.profiler.kineto_results.events())
        if run.spans is not None:
            _report(run.spans)
    return run.spans


def mean_host_ms(run, name: str) -> Optional[float]:
    """Mean host ms of the spans `name` in the slice."""
    sp = spans_of(run)
    found = None if sp is None else sp.host.get(name)
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found) / 1e6


def host_pct(run, name: str) -> Optional[float]:
    """100 x host time inside the spans `name` / the slice."""
    sp = spans_of(run)
    found = None if sp is None else sp.host.get(name)
    if not found or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(e - s for s, e in found) / 1e9 / run.trace.window_s


def device_ms_per_audio_s(run, pred: Callable[[str], bool]) -> Optional[float]:
    """Device ms launched under the spans `pred` accepts, over the requested
    audio seconds completed in the slice."""
    sp = spans_of(run)
    if sp is None:
        return None
    ns = sp.device_ns_under(pred)
    frames = run.runner.slice_counts(run.trace.t0, run.trace.t1).get("frames")
    if not ns or not frames:
        return None
    pre = run.config["preprocess_config"]
    return ns / 1e6 / (sum(frames) * pre["hop_size"] / pre["sample_rate"])
