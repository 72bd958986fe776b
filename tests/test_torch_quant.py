"""The int8 mode (ops/quant.py, MBEXWN_WN_QUANT=int8) against the JAX
package's ops/quant.py, on the same numpy inputs made from a seed.

The counterparts of tests/test_quant.py: the round-trip bounds, exactness
on the integer grid (rtol/atol 1e-5) at dilations 1, 2 and 4, the
random-input noise bound, and the int8 mode of a tiny WaveNet against its
fp stack, with determinism.  Beside them: the port's quantizers equal the
JAX package's (the same int8 values and scales), the port's int8 convs and
stack against JAX's int8 ones within 0.1 x JAX's own int8-against-fp
distance, the zero padding `torch._int_mm` needs (a reduction width that is
not a multiple of 8, as C=340 gives) exact against the unpadded product,
the count of int8 products, the CAUSAL stack left unquantized, and the
trainer's refusal of the mode.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.nn.wavenet import WaveNetAE as JaxWaveNetAE
from mbexwn_vocoder_tpu.ops import quant as jq
from mbexwn_vocoder_tpu.ops.conv import conv1d as jax_conv1d
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold

from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.ops import quant
from mbexwn_vocoder_torch.ops.conv import conv1d
from mbexwn_vocoder_torch.ops.quant import (Int8Weight, conv1x1_int8, dilated_conv1d_k3_int8, int8_matmul,
                                            quantize_act_per_sample, quantize_weight_per_cout)

from tests.test_quant import _int_representable, _rel_rms

torch.set_num_threads(2)


def _oiw(wio):
    """JAX's WIO kernel -> the port's OIW weight."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(wio).transpose(2, 1, 0)))


def test_weight_quant_roundtrip_bound():
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(24, 16, 3).astype(np.float32))
    q, s = quantize_weight_per_cout(w)
    assert q.dtype == torch.int8 and s.shape == (24,)
    err = (q.float() * s[:, None, None] - w).abs()
    assert bool((err <= s[:, None, None] / 2 + 1e-7).all())


def test_act_quant_roundtrip_bound():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 50, 8).astype(np.float32)) * torch.tensor([1.0, 10.0])[:, None, None]
    q, s = quantize_act_per_sample(x)
    assert s.shape == (2, 1, 1) and float(s[1]) > 5 * float(s[0])
    assert bool(((q.float() * s - x).abs() <= s / 2 + 1e-6).all())


def test_quantizers_equal_jax():
    """Division by the scale, round half to even, clip: the same int8 values
    and scales as the JAX package, ties included (x.5 grid values)."""
    rng = np.random.RandomState(2)
    w = rng.randn(3, 16, 24).astype(np.float32)
    x = rng.randn(3, 40, 16).astype(np.float32)
    x[0, 0, :4] = [2.5, -2.5, 0.5, 127.0]  # ties on a scale of exactly 1
    jqw, jsw = jq.quantize_weight_per_cout(jnp.asarray(w))
    qw, sw = quantize_weight_per_cout(_oiw(w))
    np.testing.assert_array_equal(qw.numpy().transpose(2, 1, 0), np.asarray(jqw))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    jqx, jsx = jq.quantize_act_per_sample(jnp.asarray(x))
    qx, sx = quantize_act_per_sample(torch.from_numpy(x))
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_dilated_conv_int8_exact_on_integer_grid(dilation):
    rng = np.random.RandomState(10 + dilation)
    x = _int_representable(rng, (2, 40, 6), per_sample=True)
    w = _int_representable(rng, (3, 6, 10), per_channel_axis=2)
    b = rng.randn(10).astype(np.float32) * 0.1
    ref = conv1d(torch.from_numpy(x), _oiw(w), torch.from_numpy(b), dilation=dilation, padding="SAME")
    got = dilated_conv1d_k3_int8(torch.from_numpy(x), _oiw(w), torch.from_numpy(b), dilation=dilation)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_conv1x1_int8_exact_on_integer_grid():
    rng = np.random.RandomState(3)
    x = _int_representable(rng, (2, 40, 12), per_sample=True)
    w = _int_representable(rng, (1, 12, 8), per_channel_axis=2)
    b = rng.randn(8).astype(np.float32) * 0.1
    ref = conv1d(torch.from_numpy(x), _oiw(w), torch.from_numpy(b))
    got = conv1x1_int8(torch.from_numpy(x), _oiw(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 4])
def test_dilated_conv_int8_noise_bound_random(dilation):
    rng = np.random.RandomState(20 + dilation)
    x = torch.from_numpy(rng.randn(2, 128, 32).astype(np.float32))
    w = torch.from_numpy((rng.randn(48, 32, 3) * 0.2).astype(np.float32))
    ref = conv1d(x, w, None, dilation=dilation, padding="SAME")
    got = dilated_conv1d_k3_int8(x, w, None, dilation=dilation)
    assert _rel_rms(got.numpy(), ref.numpy()) < 0.03


@pytest.mark.parametrize("dilation", [1, 4])
def test_int8_convs_track_jax_int8(dilation):
    """Random inputs: the port's int8 convs against JAX's within 0.1 x JAX's
    own int8-against-fp distance (int32 products are exact on both; only
    the fp32 dequantization may round differently)."""
    rng = np.random.RandomState(30 + dilation)
    x = rng.randn(2, 96, 24).astype(np.float32)
    w3, b3 = (rng.randn(3, 24, 40) * 0.2).astype(np.float32), (rng.randn(40) * 0.1).astype(np.float32)
    w1, b1 = (rng.randn(1, 24, 36) * 0.2).astype(np.float32), (rng.randn(36) * 0.1).astype(np.float32)
    cases = (
        (jq.dilated_conv1d_k3_int8(jnp.asarray(x), w3, b3, dilation),
         jax_conv1d(jnp.asarray(x), w3, b3, dilation=dilation, padding="SAME"),
         dilated_conv1d_k3_int8(torch.from_numpy(x), _oiw(w3), torch.from_numpy(b3), dilation)),
        (jq.conv1x1_int8(jnp.asarray(x), w1, b1), jax_conv1d(jnp.asarray(x), w1, b1, padding="SAME"),
         conv1x1_int8(torch.from_numpy(x), _oiw(w1), torch.from_numpy(b1))),
    )
    for j_int8, j_fp, got in cases:
        assert _rel_rms(got.numpy(), j_int8) < 0.1 * _rel_rms(j_int8, j_fp), (_rel_rms(got.numpy(), j_int8),
                                                                               _rel_rms(j_int8, j_fp))


@pytest.mark.parametrize("C", [340, 13])
def test_int_mm_padding_is_exact(C):
    """Reduction widths 3C = 1020 / 39 and C (not multiples of 8), an output
    width of C, and 5 rows (fewer than 17): the padded torch._int_mm
    product equals the unpadded integer product exactly."""
    rng = np.random.RandomState(C)
    for K, N, M in ((3 * C, 2 * C, 5), (C, C, 40)):
        xq = torch.from_numpy(rng.randint(-127, 128, (1, M, K)).astype(np.int8))
        wq = torch.from_numpy(rng.randint(-127, 128, (N, K)).astype(np.int8))
        got = int8_matmul(xq, wq)
        ref = (xq.long() @ wq.long().t()).int()
        assert got.dtype == torch.int32 and got.shape == (1, M, N) and torch.equal(got, ref)
    w = torch.randn(C, 2 * C, 3, generator=torch.Generator().manual_seed(0))
    iw = Int8Weight.of(w)
    assert iw.q.shape == (C, -(-6 * C // 8) * 8) and not iw.q[:, 6 * C:].any()


def _jax_and_port_wavenet(**kw):
    """tests/test_quant.py's WaveNet (16 channels, 4 layers, per-layer
    conditioning), with its JAX params folded and loaded into the port."""
    net = JaxWaveNetAE(n_channels=16, n_layers=4, kernel_size=3, n_out_channels=6, dilation_rate_step=1,
                       name="wn_q", **kw)
    Bn, T, n_mel = 2, 64, 12
    params = jax_fold(net.init(jax.random.PRNGKey(0), ((Bn, T, 3), (Bn, T, n_mel)))[0])
    xr = np.random.RandomState(7)
    audio = xr.randn(Bn, T, 3).astype(np.float32) * 0.4
    mel = xr.randn(Bn, T, n_mel).astype(np.float32)
    tnet = WaveNetAE(3, n_mel, n_channels=16, n_layers=4, kernel_size=3, n_out_channels=6, dilation_rate_step=1,
                     name="wn_q", **kw)
    tnet.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return net, params, tnet.eval(), audio, mel


@pytest.mark.parametrize("groups", [1, 2])
def test_wavenet_int8_mode_matches_fp_stack_and_jax_int8(groups, monkeypatch):
    """The env knob routes every per-layer conv through the int8 products
    (2 a layer and group, counted); the output is close to the fp stack,
    differs from it, is deterministic, and tracks JAX's int8 stack within
    0.1 x JAX's int8-against-fp distance."""
    jnet, params, tnet, audio, mel = _jax_and_port_wavenet(n_ch_groups=groups)
    monkeypatch.delenv("MBEXWN_WN_QUANT", raising=False)
    j_fp = np.asarray(jnet(params, (jnp.asarray(audio), jnp.asarray(mel))))
    with torch.no_grad():
        y_fp = tnet(torch.from_numpy(audio), torch.from_numpy(mel)).numpy()
        monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
        assert tnet.route() == "int8"
        before = quant.int_mm_calls
        y_q1 = tnet(torch.from_numpy(audio), torch.from_numpy(mel)).numpy()
        assert quant.int_mm_calls - before == 2 * 4 * groups
        y_q2 = tnet(torch.from_numpy(audio), torch.from_numpy(mel)).numpy()
    j_q = np.asarray(jnet(params, (jnp.asarray(audio), jnp.asarray(mel))))
    assert y_q1.shape == y_fp.shape
    np.testing.assert_array_equal(y_q1, y_q2)
    assert _rel_rms(y_q1, y_fp) < 0.2 and not np.allclose(y_q1, y_fp)
    assert _rel_rms(y_q1, j_q) < 0.1 * _rel_rms(j_q, j_fp), (_rel_rms(y_q1, j_q), _rel_rms(j_q, j_fp))


def test_int8_weights_are_cached_and_refuse_grad(monkeypatch):
    """The quantized weights are made once and kept until a parameter
    changes; like the kernel's packed weights they carry no gradient, so
    building them in grad mode for weights that require grad raises."""
    _, _, tnet, audio, mel = _jax_and_port_wavenet()
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    with torch.no_grad():
        first = tnet.int8_weights(torch.float32)
        assert tnet.int8_weights(torch.float32) is first
        tnet.res_skip_1.bias.add_(1.0)
        assert tnet.int8_weights(torch.float32) is not first
    with pytest.raises(RuntimeError, match="no backward pass"):
        tnet(torch.from_numpy(audio), torch.from_numpy(mel))


def test_causal_stack_is_not_quantized(monkeypatch):
    """As in JAX, the mode quantizes SAME stacks only: a CAUSAL stack keeps
    its route (K1's: one group, per-layer conditioning, k=3, gtu) and its
    output."""
    _, _, tnet, audio, mel = _jax_and_port_wavenet(padding="CAUSAL")
    monkeypatch.delenv("MBEXWN_WN_QUANT", raising=False)
    with torch.no_grad():
        y = tnet(torch.from_numpy(audio), torch.from_numpy(mel))
        monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
        before = quant.int_mm_calls
        assert tnet.route() == "k1"
        assert torch.equal(tnet(torch.from_numpy(audio), torch.from_numpy(mel)), y)
        assert quant.int_mm_calls == before


def test_trainer_refuses_the_int8_mode(monkeypatch):
    from mbexwn_vocoder_torch.training.trainer import Trainer

    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    with pytest.raises(RuntimeError, match="inference-only"):
        Trainer(None, {}, device="cpu")
