"""The port's tensor primitives and layers against the JAX package's, on
the same numpy inputs made from a seed, in fp32 on the CPU.  Tolerances are
rtol 1e-5 (float32 summation order), unless stated otherwise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.nn import layers as jl
from mbexwn_vocoder_tpu.nn.subnet import generate_subnet_from_specs as jax_subnet
from mbexwn_vocoder_tpu.ops import conv as jconv
from mbexwn_vocoder_tpu.ops import interp as jinterp
from mbexwn_vocoder_tpu.ops import padding as jpad
from mbexwn_vocoder_tpu.ops import pqmf_ops as jpqmf
from mbexwn_vocoder_tpu.ops import stft_ops as jstft

from mbexwn_vocoder_torch.dsp.pqmf import pqmf_filters
from mbexwn_vocoder_torch.nn import layers as tl
from mbexwn_vocoder_torch.nn.subnet import generate_subnet_from_specs as torch_subnet
from mbexwn_vocoder_torch.ops import conv as tconv
from mbexwn_vocoder_torch.ops import interp as tinterp
from mbexwn_vocoder_torch.ops import padding as tpad
from mbexwn_vocoder_torch.ops import pqmf_ops as tpqmf
from mbexwn_vocoder_torch.ops import stft_ops as tstft
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax

torch.set_num_threads(2)
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("padding,width,stride,dilation,T", [
    ("SAME", 3, 1, 1, 37), ("SAME", 3, 1, 4, 37), ("SAME", 4, 1, 2, 37), ("SAME", 3, 2, 1, 37),
    ("SAME", 5, 3, 1, 40), ("SAME", 1, 1, 1, 16), ("VALID", 3, 1, 2, 37), ("VALID", 4, 2, 1, 37),
    ("CAUSAL", 3, 1, 8, 37), ("CAUSAL", 3, 2, 1, 37), ("CAUSAL", 4, 3, 2, 40), ("CAUSAL", 5, 2, 3, 41),
    ("CAUSAL", 1, 1, 1, 16),
])
def test_conv1d_matches_jax(padding, width, stride, dilation, T):
    rng = np.random.RandomState(width * 100 + stride * 10 + dilation)
    x = rng.randn(2, T, 5).astype(np.float32)
    k = rng.randn(width, 5, 7).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    ref = jconv.conv1d(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), stride, dilation, padding)
    got = tconv.conv1d(_t(x), _t(k.transpose(2, 1, 0)), _t(b), stride, dilation, padding)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("mode", ["CONSTANT", "REFLECT", "SYMMETRIC", "EDGE"])
@pytest.mark.parametrize("pads", [(1, 1), (2, 0), (0, 3)])
def test_pad1d_matches_jax(mode, pads):
    x = np.random.RandomState(1).randn(2, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(tpad.pad1d(_t(x), *pads, mode).numpy(),
                                  np.asarray(jpad.pad1d(jnp.asarray(x), *pads, mode)))


@pytest.mark.parametrize("factor,num_pad_end,drop_last", [(5, 1, True), (25, 1, True), (3, 0, False),
                                                          (300, 0, False), (1, 1, True)])
def test_linear_interp_matches_jax(factor, num_pad_end, drop_last):
    x = np.random.RandomState(2).randn(2, 9, 4).astype(np.float32)
    ref = jinterp.linear_interp_upsample(jnp.asarray(x), factor, num_pad_end, drop_last)
    got = tinterp.linear_interp_upsample(_t(x), factor, num_pad_end, drop_last)
    assert tuple(got.shape) == ref.shape
    if factor > 1:  # factor 1 returns the padded input, as in the JAX package
        assert got.shape[1] == tinterp.linear_interp_output_length(9, factor, num_pad_end, drop_last)
    _close(got, ref)


def _jax_layer_params(layer, rng_seed, in_shape):
    params, _ = layer.init(jax.random.PRNGKey(rng_seed), in_shape)
    return jconv.fold_weight_norm(params)


def _load(module, jax_params):
    state = params_from_jax(flatten(jax_params))
    module.load_state_dict(state, strict=True)


@pytest.mark.parametrize("up_sample,factor,padding", [(True, 2, "SAME"), (True, 5, "VALID"), (False, 2, "SAME"),
                                                       (True, 2, "CAUSAL"), (False, 2, "CAUSAL")])
def test_conv_up_down_sample_matches_jax(up_sample, factor, padding):
    x = np.random.RandomState(3).randn(2, 12, 6).astype(np.float32)
    jlayer = jl.Conv1DUpDownSample(8, kernel_size=3, up_sample=up_sample, factor=factor, padding=padding)
    jp = _jax_layer_params(jlayer, 0, x.shape)
    jp["b"] = jnp.asarray(np.random.RandomState(4).randn(*jp["b"].shape).astype(np.float32))
    tlayer = tl.Conv1DUpDownSample(6, 8, kernel_size=3, up_sample=up_sample, factor=factor, padding=padding)
    _load(tlayer, jp)
    ref = jlayer(jp, jnp.asarray(x))
    got = tlayer(_t(x))
    assert tuple(got.shape) == ref.shape and tlayer.out_length(12) == ref.shape[1]
    _close(got.detach(), ref)


@pytest.mark.parametrize("padding", ["SAME", "CAUSAL", "VALID"])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (1, 4), (2, 1), (3, 2)])
def test_conv_out_length_matches_jax(padding, stride, dilation):
    """out_length: SAME and CAUSAL give ceil(T / stride), VALID the valid
    positions, as the JAX layer reports and as the conv produces."""
    x = np.random.RandomState(13).randn(1, 23, 3).astype(np.float32)
    jlayer = jl.Conv1DWeightNorm(4, kernel_size=3, strides=stride, dilation_rate=dilation, padding=padding)
    tlayer = tl.Conv1DWeightNorm(3, 4, 3, strides=stride, dilation_rate=dilation, padding=padding)
    for T in (1, 7, 23):
        assert tlayer.out_length(T) == jlayer.out_length(T)
    assert tlayer(_t(x)).shape[1] == tlayer.out_length(23)


@pytest.mark.parametrize("name", ["prelu", "leaky_relu", "soft_sigmoid", "soft_sqrt", "tanh", "sigmoid", "linear"])
def test_activations_match_jax(name):
    x = np.random.RandomState(5).randn(2, 7, 4).astype(np.float32) * 3
    ja = jl.Activation(name, alpha=0.3)
    jp, _ = ja.init(None, x.shape)
    if jp:
        jp = {"alpha": jnp.asarray(np.random.RandomState(6).rand(4).astype(np.float32))}
    ta = tl.Activation(name, alpha=0.3, channels=4)
    if jp:
        ta.load_state_dict({"alpha": _t(np.asarray(jp["alpha"]))})
    _close(ta(_t(x)).detach(), ja(jp, jnp.asarray(x)))


@pytest.mark.parametrize("specs,target_ups,pad_to_valid,final_act", [
    ([[3, 16, 2], [3, 12, "L5"], [3, 8, "L5"], [3, 6, "L3"]], 150, False, "soft_sigmoid"),
    ([[3, 16], [3, 16], [3, 16]], None, False, None),
    ([[3, 8, 2], [3, 8], ["L", 2]], 8, True, "tanh"),
])
def test_subnet_matches_jax(specs, target_ups, pad_to_valid, final_act):
    """The F0-net and envelope-net spec grammar at narrow widths: the same
    layers, names and outputs (random weights and PReLU slopes)."""
    rng = np.random.RandomState(7)
    mel = rng.randn(2, 10, 5).astype(np.float32)
    jnet, jups = jax_subnet(specs, "Net", final_n_channels=3, final_nks=1, final_activation=final_act,
                            target_ups=target_ups, pad_to_valid=pad_to_valid)
    params, _ = jnet.init(jax.random.PRNGKey(1), mel.shape)
    params = jconv.fold_weight_norm(params)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.3) if hasattr(a, "shape") else a, params)
    tnet, tups = torch_subnet(specs, "Net", in_channels=5, final_n_channels=3, final_nks=1,
                              final_activation=final_act, target_ups=target_ups, pad_to_valid=pad_to_valid)
    assert tups == jups
    assert [c.name for c in tnet.children()] == [layer.name for layer in jnet.layers]
    _load(tnet, params)
    ref = jnet(params, jnp.asarray(mel))
    got = tnet(_t(mel)).detach()
    assert tuple(got.shape) == ref.shape and tnet.out_length(10) == ref.shape[1]
    _close(got, ref)


def test_stft_istft_match_jax():
    """tf.signal framing, windowing, rfft (torch.fft vs the JAX package's
    matmul rDFT), irfft and overlap-add on the vocoder's geometry
    (window 1200, hop 300, fft 2048)."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 300 * 12 + 1201).astype(np.float32)
    win = np.hanning(1200).astype(np.float32)
    ref = jstft.stft(jnp.asarray(x), 1200, 300, 2048, jnp.asarray(win))
    got = tstft.stft(_t(x), 1200, 300, 2048, _t(win))
    assert tuple(got.shape) == ref.shape
    _close(got.real, np.real(ref), atol=2e-4)
    _close(got.imag, np.imag(ref), atol=2e-4)
    iwin = tstft.inverse_stft_window(1200, 300, win)
    np.testing.assert_array_equal(iwin, jstft.inverse_stft_window(1200, 300, win))
    spec = np.asarray(ref)
    ref_y = jstft.istft(jnp.asarray(spec), 1200, 300, 2048, jnp.asarray(iwin))
    got_y = tstft.istft(torch.from_numpy(spec.copy()), 1200, 300, 2048, _t(iwin))
    assert tuple(got_y.shape) == ref_y.shape
    _close(got_y, ref_y, atol=1e-5)


@pytest.mark.parametrize("L,S", [(1200, 300), (7, 3), (8, 4)])
def test_frame_and_overlap_add_match_jax(L, S):
    x = np.random.RandomState(9).randn(2, 3 * L + 5).astype(np.float32)
    np.testing.assert_array_equal(tstft.frame(_t(x), L, S).numpy(), np.asarray(jstft.frame(jnp.asarray(x), L, S)))
    frames = np.random.RandomState(10).randn(2, 6, L).astype(np.float32)
    _close(tstft.overlap_and_add(_t(frames), S), jstft.overlap_and_add(jnp.asarray(frames), S))


@pytest.mark.parametrize("max_band", [None, 4])
def test_pqmf_synthesis_matches_jax(max_band):
    """zero-stuff x6, pad taps//2, one VALID conv: the SPEECH bank (6 bands,
    94 taps)."""
    _, syn = pqmf_filters(6, 94, 0.0945, 9.0, max_band)
    x = np.random.RandomState(11).randn(2, 40, 6).astype(np.float32)
    ref = jpqmf.pqmf_synthesis(jnp.asarray(x), jnp.asarray(syn), 6, 94, max_band)
    got = tpqmf.pqmf_synthesis(_t(x), _t(syn.transpose(2, 1, 0)), 6, 94, max_band)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


def test_rdft_matches_numpy_rfft():
    """The envelope's 120 cepstral coefficients zero-padded to 2048."""
    c = np.random.RandomState(12).randn(2, 5, 120).astype(np.float32)
    got = tstft.rdft(_t(c), 2048).numpy()
    ref = np.fft.rfft(c.astype(np.float64), n=2048, axis=-1)
    _close(got, ref, atol=2e-5)
