"""The port's diagnostics (observability.py) on the CPU: `synthesis_flops`
against the JAX package's for the three registry models and the tiny
config, `dump_controls` (keys and shapes of `infer_components`'s signals),
`debug_nans` (raises at the first op whose output holds a NaN, silent
otherwise, nests as the JAX flag does) and `profile_trace` (writes a
trace file that names the synthesis's ops)."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.observability import synthesis_flops as jax_synthesis_flops

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.iovar import load_var
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.observability import debug_nans, dump_controls, profile_trace, synthesis_flops
from mbexwn_vocoder_torch.training.parity import tiny_hparams

torch.set_num_threads(2)
T_MEL, HOP = 8, 300


def _hparams(name):
    return tiny_hparams() if name == "tiny" else read_config(get_config_file(name))


@pytest.mark.parametrize("name", ["SPEECH", "SING", "VOICE", "tiny"])
def test_synthesis_flops_equal_jax(name):
    hp = _hparams(name)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    for T_mel, batch in ((1, 1), (512, 1), (100, 8)):
        got, want = synthesis_flops(model, T_mel, batch), jax_synthesis_flops(jmodel, T_mel, batch)
        assert got == want, (T_mel, batch, got, want)
    assert got["breakdown"]["wavenet"] > 0


@pytest.fixture(scope="module")
def tiny_model():
    hp = tiny_hparams(**{"mbexwn_config.normalize_rms_from_mell": True})
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.init(torch.Generator().manual_seed(0))
    return model.eval()


def _mel(seed=0):
    return (np.random.RandomState(seed).randn(1, T_MEL, 80) * 0.5 - 4).astype(np.float32)


def test_dump_controls_writes_the_jax_keys(tiny_model, tmp_path):
    blk = tiny_model.block
    path = str(tmp_path / "controls.pkl")
    noise = np.random.RandomState(1).randn(1, blk.wn_input_length(T_MEL), 1).astype(np.float32)
    data = dump_controls(path, tiny_model, _mel(), noise=noise)
    saved = load_var(path)
    assert sorted(saved) == sorted(data) == ["PulseFilterSpectrum", "pulse_frequency", "pulse_signal",
                                             "upsampled_rms"]
    assert saved["pulse_frequency"].shape == (1, T_MEL * blk.spect_to_pulse_upsampling_factor)
    assert saved["pulse_signal"].shape == (1, T_MEL * HOP)
    assert saved["PulseFilterSpectrum"].shape == (1, T_MEL, blk.fft_size // 2 + 1)
    assert saved["upsampled_rms"].shape == (1, T_MEL * HOP)
    assert (saved["PulseFilterSpectrum"] >= 0).all() and all(np.isfinite(v).all() for v in saved.values())
    with torch.no_grad():
        F0, excitation, _, _ = tiny_model.infer_components(torch.from_numpy(_mel()), noise=torch.from_numpy(noise))
    assert np.array_equal(saved["pulse_frequency"], F0.numpy())
    assert np.array_equal(saved["pulse_signal"], excitation.numpy())


def test_debug_nans_raises_at_the_first_nan_and_nests(tiny_model):
    mel = torch.from_numpy(_mel())
    with torch.no_grad():
        ref = tiny_model.infer(mel, synth_length=T_MEL * HOP)
        with debug_nans():
            y = tiny_model.infer(mel, synth_length=T_MEL * HOP)  # silent on a clean synthesis
        assert torch.equal(y, ref)
        bad = mel.clone()
        bad[0, 3, 7] = float("nan")
        with pytest.raises(FloatingPointError, match=r"debug_nans: aten\.\w+.* produced a NaN"):
            with debug_nans():
                tiny_model.infer(bad, synth_length=T_MEL * HOP)
        # an inner disabled scope turns the check off, and leaving it turns it back on
        nan = torch.full((2,), float("nan"))
        with debug_nans():
            with debug_nans(False):
                assert torch.isnan(nan * 2).all()
                with debug_nans():
                    with pytest.raises(FloatingPointError, match="aten.mul"):
                        nan * 2
                assert torch.isnan(nan * 2).all()
            with pytest.raises(FloatingPointError, match="aten.mul"):
                nan * 2
        assert torch.isnan(nan * 2).all()  # outside every scope


def test_debug_nans_names_a_kernel_op(tiny_model):
    """The kernels' ops are visible to the check: a NaN that first appears
    in the WaveNet stack's output is reported at mbexwn::wavenet_stack."""
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack

    wn = getattr(tiny_model.block, tiny_model.block.block_names[0]).wavenet
    with torch.no_grad():
        packed = wn.stack_weights(torch.float32)
        w_dil = packed.w_dil.clone()
        w_dil[0, 0, 0, 0] = float("nan")
        x = torch.randn(1, 40, wn.n_channels)
        cond = torch.randn(1, 40, 2 * wn.n_channels)
        with pytest.raises(FloatingPointError, match="mbexwn.wavenet_stack"):
            with debug_nans():
                wavenet_stack(x, cond, dataclasses.replace(packed, w_dil=w_dil), wn.dilations)


def test_profile_trace_writes_a_trace(tiny_model, tmp_path):
    log_dir = str(tmp_path / "trace")
    with torch.no_grad(), profile_trace(log_dir) as prof:
        tiny_model.infer(torch.from_numpy(_mel()), synth_length=T_MEL * HOP)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 1000
    with open(files[0]) as f:
        text = f.read()
    assert "mbexwn::wavenet_stack" in text and "mbexwn::oscillate" in text
    assert any(e.key == "mbexwn::wavenet_stack" for e in prof.key_averages())
