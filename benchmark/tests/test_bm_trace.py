"""The trace reduction on hand-made intervals."""
from types import SimpleNamespace

import pytest

import tracing
from _common import idle_pct


def test_union_and_gaps():
    spans = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert tracing.union_seconds(spans) == 12 + 10 + 1
    assert tracing.idle_gaps(spans) == [(12, 20), (30, 40)]
    assert tracing.union_seconds([]) == 0.0
    assert tracing.union_seconds([(3, 4), (0, 10)]) == 10


def test_idle_share():
    trace = SimpleNamespace(window_s=2.0, busy_s=1.5, n_device=10)
    assert idle_pct(SimpleNamespace(trace=trace)) == pytest.approx(25.0)
    assert idle_pct(SimpleNamespace(trace=SimpleNamespace(window_s=2.0, busy_s=0.0, n_device=0))) is None


class Ev:
    def __init__(self, name, start, dur, device=False, tid=1, corr=0, linked=0, shapes=()):
        self._n, self._s, self._d, self._dev, self._t, self._c, self._l = name, start, dur, device, tid, corr, linked
        self._shapes = shapes

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def shapes(self):
        return self._shapes


def test_attribution_by_op():
    ev = [Ev("mbexwn::wavenet_stack", 0, 100, shapes=([2, 8, 4], [2, 8, 8], [12, 8, 3, 4])),
          Ev("cuLaunchKernelEx", 10, 5, corr=1), Ev("aten::mul", 200, 20), Ev("cudaLaunchKernel", 205, 5, corr=2),
          Ev("k1_kernel", 300, 1000, device=True, linked=1), Ev("mul_kernel", 1400, 100, device=True, linked=2)]
    t = tracing.reduce_events(ev, window_s=3e-6)
    assert t.launch_calls == 2 and t.n_device == 2
    assert t.op_device_s["mbexwn::wavenet_stack"] == pytest.approx(1e-6)
    assert t.op_device_s["aten::mul"] == pytest.approx(1e-7)
    assert t.busy_s == pytest.approx(1.1e-6)
    assert t.op_shapes["mbexwn::wavenet_stack"][0][0] == [2, 8, 4]
    assert t.idle_gaps[0][1] == pytest.approx(1e-7)
