"""`graph_replay_pct.live` on hand-made events: the share of a slice's live
enqueues that replayed a captured graph, and nothing from a program that
has no replay span."""
import json

import pytest

import harness
from test_bm_spans import Ev, _read, _run


def _live(n_enqueue, n_replay):
    ev = []
    for k in range(n_enqueue):
        ev.append(Ev("mbexwn.stream.enqueue", 1000 * k, 500))
        if k < n_replay:
            ev.append(Ev("mbexwn.stream.replay", 1000 * k + 300, 20))
    return _run(ev, frames=[16] * n_enqueue)


def test_share_of_enqueues_that_replayed(monkeypatch):
    from mbexwn_vocoder_torch import observability

    monkeypatch.setattr(observability, "STREAM_REPLAY", "mbexwn.stream.replay", raising=False)
    assert _read("graph_replay_pct.live", _live(8, 8)) == pytest.approx(100.0)
    assert _read("graph_replay_pct.live", _live(8, 6)) == pytest.approx(75.0)
    assert _read("graph_replay_pct.live", _live(8, 0)) == pytest.approx(0.0)
    assert _read("graph_replay_pct.live", _live(0, 0)) is None


def test_a_program_without_the_replay_span_reads_nothing(monkeypatch):
    from mbexwn_vocoder_torch import observability

    monkeypatch.delattr(observability, "STREAM_REPLAY", raising=False)
    assert _read("graph_replay_pct.live", _live(8, 0)) is None
    untraced = _live(8, 8)
    untraced.runner.tracer.prof = None
    assert _read("graph_replay_pct.live", untraced) is None


def test_declared_for_the_live_cell():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in spec["per_layer"]}["graph_replay_pct.live"]
    assert entry["workloads"] == ["speech-live"] and entry["moves"] == "chunk_p95_ms"
    assert entry["layer"] == "Streaming"
