"""The waveglow-offline cell: found by name, its reference against the
program's CPU path at a small size, a whole run at that size (sound, and
the ref8 control), and the frozen counts against the program's own."""
import copy
import json
import tempfile

import numpy as np
import pytest
import torch

import check
import counts_waveglow
import generator as gen
import harness
from conftest import BENCH
from reference.waveglow_ref import Reference, model_dir

CONFIG = json.loads((BENCH / "configs" / "waveglow.json").read_text())
NEW_METRICS = ["k1_roofline.waveglow", "mfu.waveglow", "wavenet_device_ms_per_audio_s.waveglow",
               "flow_other_device_ms_per_audio_s.waveglow", "device_idle_pct.waveglow"]


def small_config(wn_dtype="float32"):
    """The cell's configuration at 4 flows (an early z every 2) of 3-layer WNs at C=16."""
    cfg = copy.deepcopy(CONFIG)
    cfg["waveglow_config"].update(n_flows=4, n_early_every=2, wn_compute_dtype=wn_dtype,
                                  WN_config={"n_layers": 3, "n_channels": 16, "kernel_size": 3})
    return cfg


@pytest.fixture
def own_tmp(tmp_path, monkeypatch):
    """The seeded weights go to this test's temporary directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_cell_resolves():
    cell, config, mix, e2e, per_layer = harness.resolve_cell("waveglow-offline")
    assert cell["config"] == "waveglow" and cell["chips"] == 1 and mix["runner"] == "offline_waveglow"
    assert config["reduced"] == [] and config["waveglow_config"]["WN_config"]["n_channels"] == 256
    assert sorted(m["name"] for m in e2e) == ["audio_s_per_s", "setup_s"]
    assert sorted(m["name"] for m in per_layer) == sorted(NEW_METRICS)
    assert all((BENCH / "metrics" / f"{name}.py").is_file() for name in NEW_METRICS)


def test_reference_matches_the_program_on_the_cpu(own_tmp):
    from mbexwn_vocoder_torch.mel_inverter import MELInverter

    cfg = small_config()
    path = model_dir(cfg)
    assert path.parent == own_tmp and model_dir(cfg) == path  # written once, then reused
    inv = MELInverter(str(path), device="cpu", length_buckets=(32,))
    kept = []
    inv.model.upsample.register_forward_hook(lambda m, i, o: kept.append(o))
    mel = gen.make_mel(30, 80, gen.rng_for(6))
    y = inv.synth_from_mel(mel)
    ref = Reference(cfg, path, "cpu")
    padded = torch.from_numpy(np.concatenate([mel, np.repeat(mel[:, -1:], 2, axis=1)], axis=1))
    assert check.rel_rms(kept[0], ref.upsampled(padded).transpose(1, 2)) < 1e-5
    assert check.rel_rms(y, ref.synth(padded)[0, : 30 * 256].numpy()) < 1e-5


def _run(control, monkeypatch):
    cfg = small_config()
    resolve = harness.resolve_cell

    def small(workload, spec_path=harness.ROOT / "BENCHMARK.json"):
        cell, _, mix, e2e, per_layer = resolve(workload, spec_path)
        return cell, cfg, mix, e2e, per_layer

    monkeypatch.setattr(harness, "resolve_cell", small)
    tiny = {"frames": [100, 120], "bucket": 128, "pool": 8, "batch": 2, "depth": 2, "check_groups": 1,
            "check_group_range": [0, 2], "lead_s": 0.1}
    extra = ("--control", control) if control else ()
    return harness.main(["--workload", "waveglow-offline", "--seed", "2147483999", "--seconds", "3.0", "--device",
                         "cpu", *extra], mix_override=tiny)


def test_whole_run_on_the_cpu(own_tmp, monkeypatch):
    r = _run("", monkeypatch)
    assert r["correct"] is True and r["failed"] == 0 and r["metrics"]["audio_s_per_s"]["value"] > 0
    assert r["checks"]["f0_rel"]["value"] < 1e-5 and r["checks"]["audio_rel"]["value"] < 1e-5


def test_ref8_control_fails(own_tmp, monkeypatch):
    r = _run("ref8", monkeypatch)
    assert r["correct"] is False
    assert r["checks"]["f0_rel"]["value"] > r["checks"]["f0_rel"]["limit"]
    assert r["checks"]["audio_rel"]["value"] > 1e-3  # the fp32 sound run's reads < 1e-5 at this size


def test_counts_match_the_programs():
    from mbexwn_vocoder_torch import observability
    from mbexwn_vocoder_torch.models import create_model

    hp = {"waveglow_config": CONFIG["waveglow_config"]}
    with torch.device("meta"):
        model, _ = create_model(hp, {}, CONFIG["preprocess_config"])
    for T in (1, 512, 1000):
        ours = counts_waveglow.synthesis_flops(CONFIG, T, batch=8)
        assert ours["breakdown"] == observability.waveglow_flops(model, T, batch=8)["breakdown"]
    per_audio_s = counts_waveglow.synthesis_flops(CONFIG, 22050)["flops_per_call"] / 256
    assert round(per_audio_s / 1e9) == 448
    flop, nbytes = counts_waveglow.k1_work_per_layer_cond(8, 32768, 256, 8)
    assert flop == 8 * 32768 * 126 * 256 * 256
    assert nbytes == 2 * 8 * 32768 * (256 + 2 * 256 * 8) + 2 * (8 * 8 - 1) * 256 * 256 + 4 * 8 * 32768 * 256
