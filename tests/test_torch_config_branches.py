"""The registry's configuration against the JAX package at narrow width
with random weights, through PaNWaveNet.infer in fp32 (1e-4 rel-RMS:
float32 summation order at a width where the excitation's phase cannot
drift far), and the same for config branches no registry model uses (they
raised NotImplementedError until they were ported; each case now holds
the branch against JAX at the same bound)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model

from tests.test_torch_model import jax_noise, make_mel, rel_rms

torch.set_num_threads(2)


def _small_hparams(edit):
    """SPEECH's config at narrow widths (the F0 net keeps its 150x
    upsampling), with one config branch changed."""
    hp = read_config(get_config_file("SPEECH"))
    mc = hp["mbexwn_config"]
    mc["pp_subnet"] = [[3, 8, 2], [3, 8, "L5"], [3, 8, "L5"], [3, 8, "L3"]]
    mc["ps_subnet"] = [[3, 16]]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=3, n_out_channels=8)
    edit(mc)
    return hp


def matches_jax(hp, seed=3):
    """rel-RMS of the port's fp32 `infer` from JAX's on a batch-2 mel, with
    JAX's init, folded and mapped onto the port (strict), plus random
    biases, and JAX's noise injected."""
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"])
    params = jax_fold(jmodel.init(jax.random.PRNGKey(seed), batch_size=2, T_mel=16))
    rng = np.random.RandomState(11)
    params = jax.tree_util.tree_map(  # non-zero biases, so every bias path is exercised
        lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a, params)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)

    mel = np.concatenate([make_mel(12, 16), make_mel(13, 16)]) * 0.5 - 3.0
    hop = hp["preprocess_config"]["hop_size"]
    noise = jax_noise((2, model.block.wn_input_length(16), 1))
    ref = jmodel.infer(params, jnp.asarray(mel), synth_length=16 * hop)
    with torch.no_grad():
        got = model.infer(torch.from_numpy(mel), synth_length=16 * hop, noise=torch.from_numpy(noise.copy()))
    assert tuple(got.shape) == ref.shape == (2, 16 * hop)
    return rel_rms(got, ref)


def test_registry_config_matches_jax():
    assert matches_jax(_small_hparams(lambda mc: None)) <= 1e-4


@pytest.mark.parametrize("edit", [
    lambda mc: mc.update(spect_filters_preserve_energy=True),
    lambda mc: mc.update(psns_use_cepstral_loss_constraint=True),
    lambda mc: mc.update(ps_env_order_scale=None),
    lambda mc: mc.update(filter_max_db_range=None),
    lambda mc: mc.update(internal_fft_over=1),
    lambda mc: mc.update(normalize_use_pinv=True),
    lambda mc: mc.update(max_norm_fact=120.0),  # a floor above the quietest frames
    lambda mc: mc.update(normalize_compressor_exp=0.5),
    lambda mc: mc.update(pp_mod_subnet_use_pqmf=False),
    lambda mc: mc.update(use_prelu=False),
    lambda mc: mc.update(remove_inactive_pad_layers=True, ps_subnet=[[3, 16], [1, 16]]),
], ids=["preserve_energy", "cepstral_constraint", "no_cepstral_window", "no_filter_range", "fft_over",
        "normmel_pinv", "max_norm_fact", "compressor_exp", "no_pqmf", "leaky_relu", "remove_inactive_pad"])
def test_unported_config_branches_raise(edit):
    """Each branch that raised before it was ported: `infer` against JAX's
    (a kernel-1 layer in the envelope net gives remove_inactive_pad_layers
    a pad layer to drop)."""
    assert matches_jax(_small_hparams(edit)) <= 1e-4


def test_f0_override_and_phase_offset_match_jax():
    """An external F0 contour and a phase carry (the chunked-synthesis
    inputs) reach the oscillator as in the JAX package."""
    hp = _small_hparams(lambda mc: None)
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"])
    params = jax_fold(jmodel.init(jax.random.PRNGKey(4), batch_size=2, T_mel=16))
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)

    mel = np.concatenate([make_mel(14, 16), make_mel(15, 16)]) * 0.5 - 3.0
    hop = hp["preprocess_config"]["hop_size"]
    f0 = (120.0 + 60.0 * np.sin(np.linspace(0, 6, 2 * 16 * 150))).reshape(2, -1).astype(np.float32)
    offset = np.asarray([0.25, 0.9], np.float32)
    noise = jax_noise((2, model.block.wn_input_length(16), 1))
    ref = jmodel.infer(params, jnp.asarray(mel), synth_length=16 * hop, F0=jnp.asarray(f0),
                       phase_offset=jnp.asarray(offset))
    with torch.no_grad():
        got = model.infer(torch.from_numpy(mel), synth_length=16 * hop, F0=torch.from_numpy(f0),
                          noise=torch.from_numpy(noise.copy()), phase_offset=torch.from_numpy(offset))
    assert tuple(got.shape) == ref.shape
    assert rel_rms(got, ref) <= 1e-4
