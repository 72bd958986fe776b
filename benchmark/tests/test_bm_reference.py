"""The reference agrees with the program's CPU path at a small size.

Both in fp32 (the program's compute dtypes forced to fp32), the reference
with its own F0: the whole synthesis, SAME and causal, for both
configurations; then in the shipped bf16, where the F0 stage matches bit
for bit and the synthesis from the program's F0 stays within bf16's
rounding of the WaveNet."""
import json

import pytest
import torch

import check
import generator as gen
from conftest import BENCH, ROOT
from reference.mbexwn_ref import Reference, edge_pad, weights_path


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["speech", "voice"])
@pytest.mark.parametrize("causal", [False, True], ids=["same", "causal"])
def test_fp32_whole_synthesis(name, causal, monkeypatch):
    from mbexwn_vocoder_torch.models.factory import create_registry_model

    monkeypatch.setenv("MBEXWN_WN_DTYPE", "")
    monkeypatch.setenv("MBEXWN_SUBNET_DTYPE", "")
    cfg = config(name)
    model = create_registry_model(cfg["model_id"], force_causal=causal)
    mel = torch.from_numpy(gen.make_mel(48, 80, gen.rng_for(5)))
    with torch.inference_mode():
        y = model.infer(mel, synth_length=48 * 300).numpy()
    ref = Reference(cfg, weights_path(cfg, ROOT), "cpu", causal=causal, subnet_mode="fp32")
    assert check.rel_rms(y, ref.synth(mel, 48 * 300).numpy()) < 1e-4


@pytest.mark.parametrize("name", ["speech", "voice"])
def test_bf16_facade(name):
    from mbexwn_vocoder_torch.mel_inverter import MELInverter

    cfg = config(name)
    inv = MELInverter(cfg["model_id"], device="cpu", length_buckets=(64,))
    out = []
    inv.model.block.pp_subnet.register_forward_hook(lambda m, i, o: out.append(o))
    mel = gen.make_mel(50, 80, gen.rng_for(6))
    y = inv.synth_from_mel(mel)
    ref = Reference(cfg, weights_path(cfg, ROOT), "cpu")
    padded = torch.from_numpy(edge_pad(mel, 64))
    assert torch.equal(ref.f0_net(padded), out[0])
    y_ref = ref.synth(padded, 64 * 300, f0_net_output=out[0])[0, : 50 * 300].numpy()
    assert check.rel_rms(y, y_ref) < 0.05
    assert check.hf_lsd_db(y, y_ref, 24000) < 0.5
