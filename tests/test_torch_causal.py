"""The port's force_causal model and causal streaming against the JAX
package, on the CPU in fp32 (ported in part from tests/test_parallel.py).

The model is SPEECH's config at narrow WaveNet width (16 channels, 3
layers) with `force_causal: true`, the noise channel off (sigma 0) and no
mel RMS normalisation, as the JAX package's causal tests build it; JAX's
random init (PRNGKey(0)), folded, is loaded into the port.  Budgets: the
subnets at the per-stage budgets the slice already uses (F0 1e-6,
envelope net 1e-5 rel-RMS), the WaveNet module at 5e-5 as
tests/test_torch_kernels.py, the whole causal synthesis and every
streaming mode against its JAX counterpart 1e-3 rel-RMS; chunked against
one-shot at the JAX tests' own bounds (causal, halo_right=2: 1e-3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.nn.wavenet import WaveNetAE as JaxWaveNetAE
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.parallel import StreamingSynthesizer as JaxStreamingSynthesizer

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
from mbexwn_vocoder_torch.parallel import StreamingSynthesizer

from tests.test_torch_kernels import REGISTRY_DILS, _stack_case, _torch_weights
from tests.test_torch_model import rel_rms

torch.set_num_threads(2)
T = 96
HOP = 300


def causal_small_hparams(force_causal=True):
    hp = read_config(get_config_file("SPEECH"))
    mc = hp["mbexwn_config"]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=3, n_out_channels=8)
    mc["pp_mod_subnet_noise_channel_sigma"] = 0.0
    mc["normalize_rms_from_mell"] = False
    mc["force_causal"] = force_causal
    return hp


@pytest.fixture(scope="module")
def causal_models():
    hp = causal_small_hparams()
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jmodel.init(jax.random.PRNGKey(0), batch_size=1, T_mel=8)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.block.load_state_dict(params_from_jax(flatten(jax_fold(params))), strict=True)
    return jmodel, params, model.eval()


def _mel(seed, B=1, frames=T):
    return (np.random.RandomState(seed).randn(B, frames, 80) * 0.5 - 4).astype(np.float32)


def _one_shot(model, mell):
    with torch.inference_mode():
        return model.infer(torch.from_numpy(mell), synth_length=mell.shape[1] * HOP).numpy()


def test_causal_subnets_match_jax(causal_models):
    """The F0 net and the envelope net with every pad on the left: against
    JAX, and causal (a change at frame k leaves the output before frame k-1
    as it was; the linear-interp upsamplers reach one frame back)."""
    jmodel, params, model = causal_models
    blk, jblk = model.block, jmodel.block
    mel = _mel(1, frames=48)
    with torch.inference_mode():
        f0 = blk.generate_f0(torch.from_numpy(mel)).numpy()
        env = blk.ps_subnet(torch.from_numpy(mel)).numpy()
    f0_ref = np.asarray(jblk.generate_f0(params, jnp.asarray(mel)))
    env_ref = np.asarray(jblk.ps_subnet(params["ps_subnet"], jnp.asarray(mel)))
    assert f0.shape == f0_ref.shape and rel_rms(f0, f0_ref) <= 1e-6
    assert env.shape == env_ref.shape and rel_rms(env, env_ref) <= 1e-5

    k, stp = 30, blk.spect_to_pulse_upsampling_factor
    bent = mel.copy()
    bent[:, k:] += 1.0
    with torch.inference_mode():
        f0_bent = blk.generate_f0(torch.from_numpy(bent)).numpy()
        env_bent = blk.ps_subnet(torch.from_numpy(bent)).numpy()
    np.testing.assert_array_equal(f0_bent[:, : (k - 1) * stp], f0[:, : (k - 1) * stp])
    np.testing.assert_array_equal(env_bent[:, : k - 1], env[:, : k - 1])
    assert not np.array_equal(f0_bent, f0) and not np.array_equal(env_bent, env)


def test_causal_wavenet_matches_jax():
    """WaveNetAE with CAUSAL padding (start, shared upsampled conditioning,
    the causal stack, end) against the JAX module, whose CAUSAL stacks take
    its XLA convolution path, 5e-5; and causal: a change at step k leaves
    the output before k as it was."""
    kw = dict(n_channels=16, n_layers=12, kernel_size=3, n_out_channels=8, max_log2_dilation_rate=7,
              cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4, padding="CAUSAL")
    jnet = JaxWaveNetAE(name="wn", **kw)
    rng = np.random.RandomState(5)
    B, Tw, Cin, Tm = 2, 128, 7, 16
    audio = rng.randn(B, Tw, Cin).astype(np.float32) * 0.3
    mel = rng.randn(B, Tm, 10).astype(np.float32) * 0.3
    params = jax_fold(jnet.init(jax.random.PRNGKey(0), ((B, Tw, Cin), (B, Tm, 10)))[0])
    ref = jnet(params, (jnp.asarray(audio), jnp.asarray(mel)))
    tnet = WaveNetAE(Cin, 10, name="wn", **kw)
    assert tnet.causal and tnet.dilations == list(REGISTRY_DILS)
    tnet.load_state_dict(params_from_jax(flatten(params)), strict=True)
    with torch.no_grad():
        got = tnet(torch.from_numpy(audio), torch.from_numpy(mel)).numpy()
        bent = audio.copy()
        bent[:, 77:] += 1.0
        got_bent = tnet(torch.from_numpy(bent), torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(got_bent[:, :77], got[:, :77])
    assert not np.array_equal(got_bent[:, 77:], got[:, 77:])


def test_causal_stack_plain_is_the_shifted_same_stack():
    """A causal layer reads the SAME layer's taps d steps later: with one
    layer, the causal skip at t equals the SAME skip at t - d with the
    conditioning moved d steps earlier; and the CPU wrapper is the plain
    version."""
    rng = np.random.RandomState(3)
    C, d, Tw = 8, 4, 40
    x, cond, weights = _stack_case(rng, 2, Tw, C, [d], last_skip_only=False)
    lw = _torch_weights(weights)
    cond_early = np.concatenate([cond[:, d:], np.zeros((2, d, 2 * C), np.float32)], axis=1)
    causal = wavenet_stack_plain(torch.from_numpy(x), torch.from_numpy(cond), lw, [d], causal=True).numpy()
    same = wavenet_stack_plain(torch.from_numpy(x), torch.from_numpy(cond_early), lw, [d]).numpy()
    np.testing.assert_allclose(causal[:, d:], same[:, : Tw - d], rtol=1e-6, atol=1e-6)
    assert not np.allclose(causal, wavenet_stack_plain(torch.from_numpy(x), torch.from_numpy(cond), lw, [d]).numpy())
    wrapped = wavenet_stack(torch.from_numpy(x), torch.from_numpy(cond), lw, [d], causal=True).numpy()
    np.testing.assert_array_equal(wrapped, causal)


def test_force_causal_infer_matches_jax(causal_models):
    jmodel, params, model = causal_models
    mell = _mel(2)
    y = _one_shot(model, mell)
    ref = np.asarray(jmodel.infer(params, jnp.asarray(mell), synth_length=T * HOP))
    assert y.shape == ref.shape == (1, T * HOP)
    assert rel_rms(y, ref) <= 1e-3


def test_causal_model_has_the_shipped_parameter_shapes():
    """Causal padding changes no parameter: the registry weights load into a
    force_causal model as they are."""
    shapes = {}
    for force_causal in (False, True):
        hp = causal_small_hparams(force_causal)
        model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
        shapes[force_causal] = {k: tuple(v.shape) for k, v in model.block.state_dict().items()}
    assert shapes[True] == shapes[False]


def test_causal_low_latency_chunked(causal_models):
    """force_causal + halo_right=2: two mel frames of lookahead suffice for
    chunked synthesis to match one-shot (1e-3), and one frame does not (the
    STFT overlap spans two frames): a guard against a tolerance that hides
    broken halo plumbing."""
    _, _, model = causal_models
    mell = _mel(13)
    y_one = _one_shot(model, mell)
    ss = StreamingSynthesizer(model, chunk_frames=16, halo_frames=16, halo_right=2, device="cpu")
    y = ss.synth(mell)
    assert y.shape == y_one.shape
    assert rel_rms(y, y_one) < 1e-3
    ss1 = StreamingSynthesizer(model, chunk_frames=16, halo_frames=16, halo_right=1, device="cpu")
    assert rel_rms(ss1.synth(mell), y_one) > 1e-3


def test_stream_incremental_api(causal_models):
    """stream(): slabs of 1, 4 and 7 frames give the same audio bit for bit,
    equal to synth(), within 1e-3 of one-shot, with at most 3 chunk shapes."""
    _, _, model = causal_models
    mell = _mel(14)
    y_one = _one_shot(model, mell)
    ss = StreamingSynthesizer(model, chunk_frames=16, halo_frames=16, halo_right=2, device="cpu")
    outs = {}
    for slab in (1, 4, 7):
        y = np.concatenate(list(ss.stream(mell[:, i: i + slab] for i in range(0, T, slab))), axis=1)
        assert y.shape == y_one.shape
        assert rel_rms(y, y_one) < 1e-3, slab
        outs[slab] = y
    np.testing.assert_array_equal(outs[1], outs[4])
    np.testing.assert_array_equal(outs[1], outs[7])
    np.testing.assert_array_equal(outs[1], ss.synth(mell))
    assert len(ss.programs) <= 3


def test_stream_after_warm_runs_at_most_one_new_shape(causal_models):
    """warm() runs every chunk shape of the left-halo ramp, so streaming a
    signal afterwards meets at most one new shape (the tail chunk, whose
    lookahead is cut at the signal end)."""
    _, _, model = causal_models
    ss = StreamingSynthesizer(model, chunk_frames=16, halo_frames=32, halo_right=2, device="cpu")
    ss.warm()
    warmed = set(ss.programs)
    assert warmed == {(18, 0, 16), (34, 16, 16), (50, 32, 16)}
    mell = _mel(15)
    list(ss.stream(mell[:, i: i + 4] for i in range(0, T, 4)))
    assert len(ss.programs - warmed) <= 1, ss.programs - warmed


@pytest.fixture(scope="module")
def jax_causal_streams(causal_models):
    """Each streaming mode of the JAX package on one causal input (use_jit
    as its tests run it): {mode: audio}."""
    jmodel, params, _ = causal_models
    mell = _mel(16)
    js = JaxStreamingSynthesizer(jmodel, params, chunk_frames=16, halo_frames=16, halo_right=2)
    out = {mode: getattr(js, mode)(mell) for mode in ("synth", "synth_batched", "synth_scan")}
    out["stream"] = np.concatenate(list(js.stream(mell[:, i: i + 5] for i in range(0, T, 5))), axis=1)
    return mell, out


@pytest.mark.parametrize("mode", ["synth", "synth_batched", "synth_scan", "stream"])
def test_causal_streaming_matches_jax(causal_models, jax_causal_streams, mode):
    _, _, model = causal_models
    mell, ref = jax_causal_streams
    ss = StreamingSynthesizer(model, chunk_frames=16, halo_frames=16, halo_right=2, device="cpu")
    if mode == "stream":
        got = np.concatenate(list(ss.stream(mell[:, i: i + 5] for i in range(0, T, 5))), axis=1)
    else:
        got = getattr(ss, mode)(mell)
    assert got.shape == ref[mode].shape == (1, T * HOP)
    assert rel_rms(got, ref[mode]) <= 1e-3
