"""The WaveNet module's branches beyond the registry's configuration against
the JAX package's `WaveNetAE`, with the same parameters (the JAX init,
folded, through `params_from_jax`), on the same numpy inputs made from a
seed, at tiny width (C=16, 3 layers), fp32, bound 1e-5 rel-RMS:

- each gate (gtu, glu, gfu, gsu), channel groups, per-layer and pre-cond
  conditioning, no conditioning, odd kernel sizes other than 3 (SAME and
  CAUSAL), on the inference route (`WaveNetAE.route`) and on the
  differentiable one;
- the init: the JAX tree (keys and shapes) and its scales;
- a tiny model with `n_ch_groups: 2` end to end against JAX `infer`
  (the whole-synthesis budget, 1e-3 rel-RMS).
Only a stack with one group, shared upsampled conditioning, k=3 and the
gtu gate takes the kernel; every other one runs the layer loop, and a CPU
run never builds or launches a kernel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.config import read_config as jax_read_config
from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.nn.wavenet import WaveNetAE as JaxWaveNetAE
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax, params_to_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.ops import kernel_lib

from tests.test_torch_model import rel_rms

torch.set_num_threads(2)
B, T_MEL, N_MEL, C_IN = 2, 12, 10, 7
SHARED = dict(cond_conv_upsampling=2, cond_lin_upsampling=4)  # T = 8 * T_MEL
PER_LAYER = dict(cond_conv_upsampling=None)  # the mel at the stack's rate

BRANCHES = {
    "glu": dict(activation="glu", **SHARED),
    "gfu": dict(activation="gfu", **SHARED),
    "gsu": dict(activation="gsu", **SHARED),
    "gtu-groups2": dict(n_ch_groups=2, **SHARED),
    "gsu-groups4-causal": dict(n_ch_groups=4, activation="gsu", padding="CAUSAL", **SHARED),
    "per-layer": dict(**PER_LAYER),
    "per-layer-groups2-glu": dict(n_ch_groups=2, activation="glu", **PER_LAYER),
    "pre-cond-per-layer": dict(pre_cond_layer_channels=[12, 9], **PER_LAYER),
    "pre-cond-shared": dict(pre_cond_layer_channels=[11], **SHARED),
    "no-conditioning": dict(disable_conditioning=True, **SHARED),
    "k5": dict(kernel_size=5, **SHARED),
    "k5-causal": dict(kernel_size=5, padding="CAUSAL", **SHARED),
    "k7-per-layer-gfu": dict(kernel_size=7, activation="gfu", **PER_LAYER),
    "k1": dict(kernel_size=1, **SHARED),
}


@pytest.fixture
def no_kernel_build(monkeypatch):
    """A CPU path must never build or launch a kernel."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(kernel_lib, "library", refuse)
    before = dict(kernel_lib.launches)
    yield
    assert kernel_lib.launches == before


def _kw(branch):
    return {**dict(n_channels=16, n_layers=3, kernel_size=3, n_out_channels=6, max_log2_dilation_rate=7,
                   cond_kernel_size=3), **BRANCHES[branch]}


def _inputs(kw, seed):
    rng = np.random.RandomState(seed)
    up = 1 if kw.get("cond_conv_upsampling") is None else kw["cond_conv_upsampling"] * kw["cond_lin_upsampling"]
    audio = rng.randn(B, T_MEL * up, C_IN).astype(np.float32) * 0.4
    mel = rng.randn(B, T_MEL, N_MEL).astype(np.float32) * 0.4
    return audio, mel


def _pair(branch, seed=0):
    """(JAX module, its folded params, the port's module with them loaded)."""
    kw = _kw(branch)
    jnet = JaxWaveNetAE(name="wn", **kw)
    audio, mel = _inputs(kw, seed)
    params, _ = jnet.init(jax.random.PRNGKey(seed), (audio.shape, mel.shape))
    params = jax_fold(params)
    tnet = WaveNetAE(C_IN, N_MEL, name="wn", **kw)
    tnet.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return jnet, params, tnet.eval()


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_matches_jax(branch, no_kernel_build):
    jnet, params, tnet = _pair(branch)
    audio, mel = _inputs(_kw(branch), 1)
    ref = np.asarray(jnet(params, (jnp.asarray(audio), jnp.asarray(mel))))
    # one group, k=3 and gtu leave the stack to the kernel (its plain version here), whatever the conditioning
    assert tnet.route() == ("k1" if branch in ("pre-cond-shared", "per-layer", "pre-cond-per-layer") else "layers")
    with torch.no_grad():
        got = tnet(torch.from_numpy(audio), torch.from_numpy(mel)).numpy()
        tnet.differentiable = True
        got_diff = tnet(torch.from_numpy(audio), torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape
    assert rel_rms(got, ref) <= 1e-5, rel_rms(got, ref)
    assert rel_rms(got_diff, ref) <= 1e-5, rel_rms(got_diff, ref)


def test_only_the_kernel_configuration_takes_the_kernel(monkeypatch):
    """The JAX package's rule widened to per-layer conditioning: one group,
    conditioning (shared upsampled or per layer), k=3, gtu and no tp axis
    take the kernel (SAME or CAUSAL), and such a stack can be frozen; the
    int8 mode takes a SAME k=3 stack ahead of it; the rest run the layer
    loop."""
    monkeypatch.delenv("MBEXWN_WN_QUANT", raising=False)
    base = dict(n_channels=8, n_out_channels=4, cond_conv_upsampling=1)
    assert WaveNetAE(3, 5, **base).route() == "k1"
    assert WaveNetAE(3, 5, padding="CAUSAL", **base).route() == "k1"
    per_layer = WaveNetAE(3, 5, **{**base, "cond_conv_upsampling": None})
    assert per_layer.route() == "k1"
    assert per_layer.freeze_stack_(torch.float32).route() == "k1"
    for kw in (dict(n_ch_groups=2), dict(kernel_size=5), dict(activation="glu"),
               dict(tp_axis="model"), dict(disable_conditioning=True)):
        net = WaveNetAE(3, 5, **{**base, **kw})
        assert net.route() == "layers", kw
        with pytest.raises(ValueError, match="cannot be frozen"):
            net.freeze_stack_(torch.float32)
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    assert WaveNetAE(3, 5, **base).route() == "int8"
    assert WaveNetAE(3, 5, activation="glu", n_ch_groups=2, **base).route() == "int8"
    assert WaveNetAE(3, 5, padding="CAUSAL", **base).route() == "k1"  # a CAUSAL stack is not quantized
    assert WaveNetAE(3, 5, kernel_size=5, **base).route() == "layers"
    net = WaveNetAE(3, 5, **base)
    net.differentiable = True
    assert net.route() == "layers"
    with pytest.raises(ValueError, match="tp_axis"):
        WaveNetAE(3, 5, tp_axis="data", **base)


def test_group_and_precond_layer_names_follow_jax():
    """`conv1D_{i}g{g}` / `res_skip_{i}g{g}` for groups > 0, `precond_{i}`,
    one per-layer cond conv of 2*C*n_layers channels, and params_to_jax
    gives the JAX tree back."""
    kw = _kw("per-layer-groups2-glu")
    kw["pre_cond_layer_channels"] = [12]
    jnet = JaxWaveNetAE(name="wn", **kw)
    audio, mel = _inputs(kw, 0)
    ref = flatten(jax.device_get(jnet.init(jax.random.PRNGKey(0), (audio.shape, mel.shape))[0]))
    tnet = WaveNetAE(C_IN, N_MEL, name="wn", **kw)
    for m in tnet.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.trainable_()
    tnet.load_state_dict(params_from_jax(ref), strict=True)
    got = params_to_jax(tnet.state_dict())
    assert got.keys() == ref.keys() and {"conv1D_2g1/v", "res_skip_0g1/g", "precond_0/b"} <= ref.keys()
    assert all(np.array_equal(got[k], np.asarray(ref[k])) for k in ref)
    assert tnet.cond.filters == 2 * 16 * 3


def _port_init(net, seed):
    gen = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.init(gen)
    return params_to_jax(net.state_dict())


@pytest.mark.parametrize("branch", ["per-layer-groups2-glu", "pre-cond-shared", "k7-per-layer-gfu"])
def test_init_matches_jax_tree_and_scales(branch):
    """The trainable form's init: the JAX tree (keys, shapes), g = ||v|| per
    channel, zero bias, and every conv's scale (mean g, averaged over 8
    inits on each side) within 10%."""
    kw = _kw(branch)
    audio, mel = _inputs(kw, 0)
    jnet = JaxWaveNetAE(name="wn", **kw)
    jinit = jax.jit(lambda k: jnet.init(k, (audio.shape, mel.shape))[0])
    jax_flats = [flatten(jax.device_get(jinit(jax.random.PRNGKey(s)))) for s in range(8)]
    tnet = WaveNetAE(C_IN, N_MEL, name="wn", **kw)
    for m in tnet.modules():
        if isinstance(m, Conv1DWeightNorm):
            m.trainable_()
    port_flats = [_port_init(tnet, s) for s in range(8)]
    ref, got = jax_flats[0], port_flats[0]
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        if k.endswith("/b"):
            assert not got[k].any()
        if k.endswith("/v"):
            norm = np.sqrt(np.sum(got[k].astype(np.float64) ** 2, axis=(0, 1)))
            np.testing.assert_allclose(got[k[:-2] + "/g"], norm, rtol=1e-5, err_msg=k)
    convs = [k[:-2] for k in ref if k.endswith("/g")]
    port_scale = {k: np.mean([f[k + "/g"].mean() for f in port_flats]) for k in convs}
    jax_scale = {k: np.mean([f[k + "/g"].mean() for f in jax_flats]) for k in convs}
    worst = max((abs(port_scale[k] / jax_scale[k] - 1), k) for k in jax_scale)
    assert worst[0] <= 0.1, worst


def test_groups2_model_matches_jax_infer(no_kernel_build):
    """A tiny SPEECH model with `n_ch_groups: 2` (16 channels, 3 layers, the
    noise channel off, no mel normalisation): the port's `infer` against
    JAX `infer` with the same folded params, 1e-3 rel-RMS."""
    import mbexwn_vocoder_tpu as mv

    edits = dict(n_channels=16, n_layers=3, n_out_channels=8, n_ch_groups=2)

    def edit(hp):
        mc = hp["mbexwn_config"]
        mc["pp_mod_subnet"].update(edits)
        mc["pp_mod_subnet_noise_channel_sigma"] = 0.0
        mc["normalize_rms_from_mell"] = False
        return hp

    jhp = edit(jax_read_config(mv.get_config_file("SPEECH")))
    jmodel, _ = jax_create_model(jhp, jhp["training_config"], jhp["preprocess_config"], quiet=True)
    params = jax_fold(jmodel.init(jax.random.PRNGKey(0), batch_size=1, T_mel=8))
    hp = edit(read_config(get_config_file("SPEECH")))
    model = create_model(hp, hp["training_config"], hp["preprocess_config"])[0]
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)
    blocks = [getattr(model.block, n).wavenet for n in model.block.block_names]
    assert all(wn.n_ch_groups == 2 and wn.route() == "layers" for wn in blocks)
    mel = (np.random.RandomState(3).randn(2, 16, 80) * 0.5 - 4).astype(np.float32)
    ref = np.asarray(jmodel.infer(params, jnp.asarray(mel), synth_length=16 * 300))
    with torch.no_grad():
        got = model.eval().infer(torch.from_numpy(mel), synth_length=16 * 300).numpy()
    assert got.shape == ref.shape and rel_rms(got, ref) <= 1e-3, rel_rms(got, ref)
