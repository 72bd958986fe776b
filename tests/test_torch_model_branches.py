"""The model's opt-in branches (excitation, envelope and gain, NormMel,
subnets and layers) against the JAX package, on the CPU in fp32.

Each branch is SPEECH's config at narrow widths
(tests/test_torch_config_branches.py `_small_hparams`: 16 WaveNet
channels, 3 layers) with the branch switched on.  JAX's init is folded,
made distinct with random biases, mapped onto the port by `params_from_jax`
with `strict=True` and given the same mel; JAX's noise
(`jax.random.normal(PRNGKey(0))`) is injected into the port.  `infer` is
held to JAX's within 1e-4 rel-RMS, the bound of
tests/test_torch_config_branches.py.

Beside it: the control signals without the STFT envelope, the modes that
feed the phase carry (sinusoidal tables, the analytic pulse, subharmonic
channels) chunked against one-shot (1e-3, with the noise channel and the
normalisation off), the subnets' parameter tree without PReLUs and pad
layers, and equalized LR without weight norm on every route of the
WaveNet stack.
"""
import copy

import numpy as np
import pytest
import torch

import jax

from mbexwn_vocoder_tpu.models import create_model as jax_create_model

from mbexwn_vocoder_torch.compat.params_io import flatten, params_to_jax
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm, LeakyReLU, Pad1d
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.parallel import StreamingSynthesizer

from tests.test_torch_config_branches import _small_hparams, matches_jax
from tests.test_torch_model import rel_rms

torch.set_num_threads(2)

PULSE_PQMF = {"subbands": 6, "taps": 94, "cutoff_ratio": 0.0945, "beta": 9.0}
NORMMEL_ALL = dict(normalize_use_pinv=True, max_norm_fact=120.0, normalize_compressor_exp=0.5,
                   normalize_rms_num_smooth_iters=2, normalize_smooth_win_scale=1.5,
                   normalize_smooth_with_squared_win=False)


def _wavetable(**kw):
    return lambda mc: mc["wavetable_config"].update(**kw)


def _pulse_pqmf(mc):
    mc.update(pulse_channels_use_pqmf=True, pulse_channels_multi_band_config=dict(PULSE_PQMF))


BRANCHES = {
    "use_sinusoid": _wavetable(use_sinusoid=True),
    "use_sinusoid_as_fun": _wavetable(use_sinusoid_as_fun=True),
    "add_subharm_chans_2": _wavetable(add_subharm_chans=2),
    "sinusoid_as_fun_subharm": _wavetable(use_sinusoid_as_fun=True, add_subharm_chans=1),
    "pulse_pqmf_fold": _pulse_pqmf,
    "pulse_pqmf_fold_subharm": lambda mc: (_pulse_pqmf(mc), mc["wavetable_config"].update(add_subharm_chans=1)),
    "multiband_gain": lambda mc: mc.update(ps_use_stft=False),
    "multiband_gain_preserve_energy": lambda mc: mc.update(ps_use_stft=False, spect_filters_preserve_energy=True),
    "ps_off": lambda mc: mc.update(ps_off=True),
    "equalized_lr_no_weight_norm": lambda mc: mc["pp_mod_subnet"].update(use_weight_norm=False,
                                                                         use_equalized_lr=True),
    "normmel_smoothing": lambda mc: mc.update(normalize_rms_num_smooth_iters=2),
    "normmel_every_option": lambda mc: mc.update(**NORMMEL_ALL),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_branch_matches_jax(branch):
    assert matches_jax(_small_hparams(BRANCHES[branch])) <= 1e-4


@pytest.mark.parametrize("branch", ["multiband_gain", "ps_off"])
def test_control_signals_without_the_stft_envelope(branch):
    """Without the STFT envelope the signal is the excitation and PP holds
    the F0 alone, as in JAX; `ps_off` has no envelope net and still loads
    strictly."""
    hp = _small_hparams(BRANCHES[branch])
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    assert (model.block.ps_subnet is None) == (branch == "ps_off")
    model.block.load_state_dict(model.block.state_dict(), strict=True)
    mel = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 80).astype(np.float32) * 0.5 - 4)
    with torch.no_grad():
        y, PP = model.infer(mel, synth_length=2400, return_F0=True)
    assert y.shape == (1, 2400) and [name for name, _ in PP] == ["F0"] and PP[0][1].shape == (1, 600)


def _streaming_model(edit):
    """The branch with the noise channel off and no normalisation, the
    JAX init drawn by the port (`init`), folded."""
    def edit_all(mc):
        edit(mc)
        mc.update(pp_mod_subnet_noise_channel_sigma=0.0, normalize_rms_from_mell=False)
    hp = _small_hparams(edit_all)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    return model.init(torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("branch", ["use_sinusoid", "use_sinusoid_as_fun", "add_subharm_chans_2"])
def test_chunked_modes_match_one_shot(branch):
    """The phase carry reaches these modes: chunked `synth` and
    `synth_batched` equal one-shot within 1e-3."""
    model = _streaming_model(BRANCHES[branch])
    mell = (np.random.RandomState(1).randn(1, 96, 80) * 0.5 - 4).astype(np.float32)
    with torch.inference_mode():
        one = model.infer(torch.from_numpy(mell), synth_length=96 * 300).numpy()
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    for y in (ss.synth(mell), ss.synth_batched(mell)):
        assert y.shape == one.shape and rel_rms(y, one) < 1e-3, rel_rms(y, one)


def test_leaky_relu_subnets_without_inactive_pad_layers():
    """use_prelu: false and remove_inactive_pad_layers: leaky ReLUs (no
    alpha parameters) and no pad layer before a kernel-1 conv; the layers
    keep their spec-index names, so the parameter tree is JAX's (keys and
    shapes of its init)."""
    hp = _small_hparams(lambda mc: mc.update(use_prelu=False, remove_inactive_pad_layers=True,
                                             ps_subnet=[[3, 16], [1, 16], [3, 16]]))
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    names = [m.name for m in model.block.ps_subnet.children()]
    assert "PS_Pad_1" not in names and "PS_Pad_0" in names and "PS_Pad_2" in names and "PS_Layer_1" in names
    assert all(isinstance(m, LeakyReLU) for m in model.block.ps_subnet.children() if "ActLayer" in m.name)
    assert sum(isinstance(m, Pad1d) for m in model.block.ps_subnet.children()) == 2
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    ref = flatten(jax.jit(lambda k: jmodel.init(k, batch_size=1, T_mel=8))(jax.random.PRNGKey(0)))
    got = params_to_jax(model.init(torch.Generator().manual_seed(0)).block.state_dict())
    assert got.keys() == ref.keys() and all(got[k].shape == ref[k].shape for k in ref)
    assert not any(k.endswith("/alpha") for k in got)


def _post_gain_stack(**kw):
    """A stack with equalized LR and no weight norm, the kernel's shape
    (shared cond, k=3, gtu), distinct gains and biases."""
    net = WaveNetAE(5, 6, n_channels=16, n_layers=3, n_out_channels=4, use_weight_norm=False,
                    use_equalized_lr=True, cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4, **kw)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.init(gen)
            with torch.no_grad():
                m.g.mul_(1.0 + 0.5 * torch.rand(m.g.shape, generator=gen))
                m.bias.add_(0.05 * torch.randn(m.bias.shape, generator=gen))
    return net.eval()


def test_equalized_lr_without_weight_norm_on_every_route(monkeypatch):
    """The post-gain form {kernel, g}: the kernel's route (its plain version
    here) and the int8 route take g * kernel, so both compute the layer
    loop's g * conv(x, kernel) + b (the kernel's route within 1e-5; int8
    within its quantization noise, 5e-2, where dropping g, as JAX's int8
    route does, lands far off)."""
    net = _post_gain_stack()
    assert all(m.post_gain and set(dict(m.named_parameters())) == {"weight", "g", "bias"}
               for m in net.modules() if isinstance(m, Conv1DWeightNorm))
    rng = np.random.RandomState(2)
    audio = torch.from_numpy(rng.randn(2, 48, 5).astype(np.float32) * 0.5)
    mel = torch.from_numpy(rng.randn(2, 6, 6).astype(np.float32))
    monkeypatch.delenv("MBEXWN_WN_QUANT", raising=False)
    with torch.no_grad():
        assert net.route() == "k1"
        y_k1 = net(audio, mel)
        net.differentiable = True
        y_layers = net(audio, mel)
        net.differentiable = False
        monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
        assert net.route() == "int8"
        y_int8 = net(audio, mel)
        for m in net.modules():
            if isinstance(m, Conv1DWeightNorm):
                m.g.fill_(1.0)
        net._int8_cache = None
        y_int8_no_g = net(audio, mel)
    assert rel_rms(y_k1, y_layers) <= 1e-5, rel_rms(y_k1, y_layers)
    assert rel_rms(y_int8, y_layers) <= 5e-2, rel_rms(y_int8, y_layers)
    assert rel_rms(y_int8_no_g, y_layers) > 0.2, rel_rms(y_int8_no_g, y_layers)


def test_equalized_lr_without_weight_norm_keeps_its_form():
    """The post-gain convs hold (weight, g, bias) in both forms: `trainable_`
    and `fold_` leave them, and `init` draws JAX's kernel / rms and g = rms."""
    hp = _small_hparams(BRANCHES["equalized_lr_no_weight_norm"])
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.init(torch.Generator().manual_seed(0))
    keys = set(model.block.state_dict())
    conv = model.block.PP_waveNetBlock_ups2_0.wavenet.conv1D_0
    k = conv.weight.detach()
    assert torch.allclose(conv.g, conv.g[0].expand_as(conv.g))
    assert abs(float(torch.sqrt(torch.mean(k * k))) - 1.0) < 1e-5
    model.trainable_()
    assert model.trainable and "PP_waveNetBlock_ups2_0.wavenet.conv1D_0.g" in set(model.block.state_dict())
    model.fold_()
    assert set(model.block.state_dict()) == keys
    model2 = copy.deepcopy(model)
    model2.block.load_state_dict(model.block.state_dict(), strict=True)
