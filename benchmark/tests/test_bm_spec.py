"""BENCHMARK.json and the files it names: found by name, unknown names refused."""
import json
import re

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    import harness

    entry, config, mix, e2e, per_layer = harness.resolve_cell(cell["name"])
    assert entry is not None and config["model_id"] and mix["runner"]
    assert (BENCH / "runners" / f"{mix['runner']}.py").is_file()
    assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
    assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
    assert per_layer and all((BENCH / "metrics" / f"{m['name']}.py").is_file() for m in per_layer)


def test_unknown_workload_is_refused():
    import harness

    with pytest.raises(SystemExit) as err:
        harness.resolve_cell("no-such-cell")
    assert err.value.code != 0


def test_names_units_and_references():
    configs = {c["name"] for c in SPEC["configs"]}
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for item in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_unknown_mix_or_metric_file_is_refused(tmp_path):
    import harness

    with pytest.raises(SystemExit):
        harness.load_module(BENCH / "metrics" / "no_such_metric.py", "no_such_metric")
    with pytest.raises(SystemExit):
        harness.load_json(BENCH / "traffic" / "no_such_mix.json", "traffic")
