"""The span reduction (`metrics/_spans.py`) and its readers on hand-made events."""
from types import SimpleNamespace

import pytest

import _spans
import harness


class Ev:
    def __init__(self, name, start, dur, device=False, tid=1, corr=0, linked=0):
        self._n, self._s, self._d, self._dev, self._t, self._c, self._l = name, start, dur, device, tid, corr, linked

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


def _run(events, window_s=1e-5, frames=(), hop=300, sr=24000):
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    runner = SimpleNamespace(tracer=SimpleNamespace(prof=prof),
                             slice_counts=lambda t0, t1: {"frames": list(frames), "chunks": len(frames)})
    return SimpleNamespace(trace=SimpleNamespace(window_s=window_s, t0=0.0, t1=1.0), runner=runner,
                           config={"preprocess_config": {"hop_size": hop, "sample_rate": sr}})


def _read(name, run):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", name).read(run)


def test_a_span_holds_every_launch_past_256_enclosed_ops():
    """A group's span encloses many more ops than `tracing`'s window of 256:
    every launch under it, the last included, is attributed to it."""
    ev = [Ev("mbexwn.serving.dispatch", 0, 100_000)]
    for k in range(600):
        ev.append(Ev("aten::mul", 10 + 100 * k, 50))
    for k in range(300):
        ev.append(Ev("cudaLaunchKernel", 20 + 300 * k, 5, corr=k + 1))
        ev.append(Ev("mul_kernel", 200_000 + 10 * k, 10, device=True, linked=k + 1))
    sp = _spans.reduce_spans(ev)
    assert sp.total_device_ns() == 3000
    assert sp.device_ns_under(lambda n: n == "mbexwn.serving.dispatch") == 3000


def test_device_events_link_to_their_launch_by_correlation_id():
    ev = [Ev("mbexwn.stream.enqueue", 0, 100, tid=1), Ev("mbexwn.model.wavenet.b0", 10, 50, tid=1),
          Ev("mbexwn::wavenet_stack", 20, 10, tid=1), Ev("cuLaunchKernelEx", 22, 2, tid=1, corr=7),
          Ev("cudaMemcpyAsync", 90, 5, tid=1, corr=8),
          # the same correlation id on another thread's call outside every span
          Ev("cudaLaunchKernel", 30, 2, tid=2, corr=9),
          Ev("k1", 1000, 40, device=True, linked=7), Ev("Memcpy DtoH", 1100, 3, device=True, corr=8),
          Ev("other", 1200, 11, device=True, linked=9), Ev("orphan", 1300, 13, device=True, linked=99),
          # a device-side range a profiler derives from a host range: no device work
          Ev("mbexwn.stream.enqueue", 1000, 103, device=True)]
    sp = _spans.reduce_spans(ev)
    assert sp.device_ns[frozenset({"mbexwn.stream.enqueue", "mbexwn.model.wavenet.b0", "mbexwn::wavenet_stack"})] == 40
    assert sp.device_ns[frozenset({"mbexwn.stream.enqueue"})] == 3  # linked by its own correlation id
    assert sp.device_ns[frozenset()] == 11 + 13  # launched outside every span, or by no call seen
    assert sp.device_ns_under(lambda n: n.startswith(_spans.WAVENET)) == 40
    assert sp.host["mbexwn.model.wavenet.b0"] == [(10, 60)]
    assert sp.total_device_ns() == 40 + 3 + 11 + 13 and len(sp.device) == 4


def test_a_launch_at_a_span_edge_is_inside_it():
    ev = [Ev("mbexwn.model.f0_net", 10, 10), Ev("cudaLaunchKernel", 10, 1, corr=1),
          Ev("cudaLaunchKernel", 20, 1, corr=2), Ev("cudaLaunchKernel", 21, 1, corr=3),
          Ev("a", 100, 1, device=True, linked=1), Ev("b", 200, 2, device=True, linked=2),
          Ev("c", 300, 4, device=True, linked=3)]
    assert _spans.reduce_spans(ev).device_ns_under(lambda n: n == "mbexwn.model.f0_net") == 3


def test_idle_inside_spans():
    assert _spans.merge([(5, 8), (0, 3), (2, 4), (8, 9)]) == [(0, 4), (5, 9)]
    assert _spans.overlap_ns([(0, 100), (200, 300)], [(50, 150), (250, 260)]) == 50 + 10
    sp = _spans.Spans(host={"mbexwn.stream.enqueue": [(0, 100), (200, 300)]},
                      device=[(50, 150), (250, 260), (120, 130)], device_ns={})
    assert _spans.idle_under_ns(sp, "mbexwn.stream.enqueue") == (100 - 50) + (100 - 10)
    run = _run([], window_s=1e-6)
    run.spans = sp
    assert _read("idle_in_enqueue_pct.live", run) == pytest.approx(100.0 * 140 / 1000)


def test_readers_of_a_traced_group():
    ev = [Ev("mbexwn.serving.dispatch", 0, 4000), Ev("mbexwn.model.normmel", 100, 100),
          Ev("mbexwn.model.wavenet.b0", 300, 1000), Ev("mbexwn.model.wavenet.b1", 1400, 1000),
          Ev("mbexwn.model.envelope", 2500, 500), Ev("mbexwn.serving.dispatch", 5000, 2000),
          Ev("mbexwn.serving.collect_wait", 8000, 1500)]
    for k, t in enumerate((150, 350, 1500, 2600, 3500)):  # the last launch in the dispatch span only
        ev += [Ev("cudaLaunchKernel", t, 5, corr=k + 1), Ev("kernel", 10_000 + 100 * k, 10 * (k + 1), device=True,
                                                              linked=k + 1)]
    run = _run(ev, window_s=1e-5, frames=[800, 800], hop=300, sr=24000)  # 20 audio-s
    assert _read("dispatch_ms_per_group.offline", run) == pytest.approx(3000 / 1e6)
    assert _read("collect_wait_pct.offline", run) == pytest.approx(15.0)
    assert _read("wavenet_device_ms_per_audio_s.offline", run) == pytest.approx((20 + 30) / 1e6 / 20)
    assert _read("other_stages_device_ms_per_audio_s.offline", run) == pytest.approx((10 + 40) / 1e6 / 20)


def test_no_spans_read_nothing():
    """A program without spans (the parent of the change that added them),
    or a run that traced nothing, reads None and raises nothing."""
    plain = [Ev("aten::mul", 0, 10), Ev("cudaLaunchKernel", 2, 1, corr=1), Ev("k", 20, 5, device=True, linked=1),
             Ev("bench.idle_until_due", 30, 100)]
    assert _spans.reduce_spans(plain) is None
    names = ["dispatch_ms_per_group.offline", "collect_wait_pct.offline", "wavenet_device_ms_per_audio_s.offline",
             "other_stages_device_ms_per_audio_s.offline", "enqueue_ms_per_chunk.live",
             "readback_ms_per_chunk.live", "idle_in_enqueue_pct.live"]
    for run in (_run(plain, frames=[100]), _run([], frames=[100])):
        assert [_read(n, run) for n in names] == [None] * len(names)
    untraced = _run([])
    untraced.runner.tracer.prof = None
    assert [_read(n, untraced) for n in names] == [None] * len(names)
    # spans but no device time (a CPU run): the host readers read, the device readers do not
    cpu = _run([Ev("mbexwn.stream.enqueue", 0, 2000), Ev("mbexwn.stream.readback", 2000, 500)], frames=[16])
    assert [_read(n, cpu) for n in names[4:]] == [pytest.approx(0.002), pytest.approx(0.0005), None]
    assert _read("wavenet_device_ms_per_audio_s.offline", cpu) is None


def test_every_span_metric_is_declared():
    import json

    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name, cells in (("dispatch_ms_per_group.offline", ["speech-offline", "voice-offline"]),
                        ("enqueue_ms_per_chunk.live", ["speech-live"])):
        assert declared[name]["workloads"] == cells
        assert (harness.BENCH / "metrics" / f"{name}.py").is_file()
