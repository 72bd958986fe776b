"""The plain versions of the two CUDA kernels against the JAX package's
Pallas kernels (interpret mode, as the JAX package's own tests run them on
the CPU) and against its plain XLA paths, on the same numpy inputs.

K1: the dilated gated WaveNet stack (ops/wavenet_stack.py vs
    ops/pallas_wavenet.py), C=8, T=512, the registry's 12-layer dilation set
    with a skip-only tail; rtol/atol 5e-5 as tests/test_pallas_wavenet.py.
K2: the oscillator stage, F0 -> phase -> lookup -> cross-fade
    (ops/oscillator.py vs the JAX package's stable_cumsum_and_wrap and
    ops/pallas_oscillator.py) on the (513, 13) registry tables: the lookup
    1e-5, the whole stage 1e-4 rel-RMS; and the phase arithmetic that the
    CUDA kernel's parallel fp64 scan relies on, bit for bit.
On a CPU tensor each wrapper runs its plain version and launches nothing.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.nn.wavenet import WaveNetAE as JaxWaveNetAE
from mbexwn_vocoder_tpu.nn.wavenet import _gate as jax_gate
from mbexwn_vocoder_tpu.ops import oscillator as josc
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.ops.pallas_oscillator import oscillator_fused
from mbexwn_vocoder_tpu.ops.pallas_wavenet import fused_wavenet_stack

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, load_params, params_from_jax
from mbexwn_vocoder_torch.dsp.wavetable import build_wavetable_grid
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.ops import kernel_lib
from mbexwn_vocoder_torch.ops import oscillator as tosc
from mbexwn_vocoder_torch.ops.wavenet_stack import gate, wavenet_stack, wavenet_stack_plain

torch.set_num_threads(2)
REGISTRY_DILS = (1, 2, 4, 8, 16, 32, 64, 1, 2, 4, 8, 16)


@pytest.fixture
def no_kernel_build(monkeypatch):
    """A CPU path must never build or launch a kernel."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(kernel_lib, "library", refuse)
    before = dict(kernel_lib.launches)
    yield
    assert kernel_lib.launches == before


def _stack_case(rng, B, T, C, dils, last_skip_only=True):
    x = rng.randn(B, T, C).astype(np.float32) * 0.3
    cond = rng.randn(B, T, 2 * C).astype(np.float32) * 0.2
    weights = []
    for i in range(len(dils)):
        out_rs = C if (last_skip_only and i == len(dils) - 1) else 2 * C
        weights.append((rng.randn(3, C, 2 * C).astype(np.float32) * 0.2, rng.randn(2 * C).astype(np.float32) * 0.05,
                        rng.randn(C, out_rs).astype(np.float32) * 0.2, rng.randn(out_rs).astype(np.float32) * 0.05))
    return x, cond, weights


def _torch_weights(weights, dtype=torch.float32):
    """JAX layout (3, C, 2C) / (C, out) -> the port's N-major (2C, 3, C) / (out, C)."""
    return [(torch.from_numpy(wd).permute(2, 0, 1).contiguous().to(dtype), torch.from_numpy(bd).to(dtype),
             torch.from_numpy(wr).t().contiguous().to(dtype), torch.from_numpy(br).to(dtype))
            for wd, bd, wr, br in weights]


def test_k1_plain_matches_pallas_stack(no_kernel_build):
    """C=8, T=512, 12 layers in 3 groups with tiling, skip-only tail."""
    rng = np.random.RandomState(1)
    x, cond, weights = _stack_case(rng, 2, 512, 8, REGISTRY_DILS)
    ref = fused_wavenet_stack(jnp.asarray(x), jnp.asarray(cond),
                              [tuple(jnp.asarray(w) for w in lw) for lw in weights],
                              REGISTRY_DILS, group_size=4, interpret=True)
    got = wavenet_stack(torch.from_numpy(x), torch.from_numpy(cond), _torch_weights(weights), REGISTRY_DILS)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5, atol=5e-5)


def test_k1_plain_matches_layerwise_reference_with_res_tail(no_kernel_build):
    """All layers with res columns, against a float64 numpy loop."""
    rng = np.random.RandomState(2)
    dils = (1, 2, 4, 8)
    x, cond, weights = _stack_case(rng, 1, 96, 8, dils, last_skip_only=False)
    got = wavenet_stack_plain(torch.from_numpy(x), torch.from_numpy(cond), _torch_weights(weights), dils).numpy()
    xr = x.astype(np.float64)
    skip = np.zeros_like(xr)
    for (wd, bd, wr, br), d in zip(weights, dils):
        xp = np.pad(xr, ((0, 0), (d, d), (0, 0)))
        y = xp[:, :96] @ wd[0] + xp[:, d:d + 96] @ wd[1] + xp[:, 2 * d:2 * d + 96] @ wd[2] + bd + cond
        g = np.tanh(y[..., :8]) / (1 + np.exp(-y[..., 8:]))
        rs = g @ wr + br
        xr = xr + rs[..., :8]
        skip = skip + rs[..., 8:]
    np.testing.assert_allclose(got, skip, rtol=5e-5, atol=5e-5)


def test_k1_plain_bf16_close_to_fp32(no_kernel_build):
    """bf16 operands round x and the gated activation like the JAX kernel;
    the skip sum stays within bf16-rounding distance of fp32 (rel-RMS 5e-2,
    the JAX package's own bound for its bf16 kernel)."""
    rng = np.random.RandomState(3)
    dils = (1, 2, 4, 8)
    x, cond, weights = _stack_case(rng, 1, 128, 8, dils)
    ref = wavenet_stack(torch.from_numpy(x), torch.from_numpy(cond), _torch_weights(weights), dils).numpy()
    wb = _torch_weights(weights, torch.bfloat16)
    got = wavenet_stack(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(cond).to(torch.bfloat16), wb, dils)
    assert got.dtype == torch.float32
    rel = np.sqrt(np.mean((got.numpy() - ref) ** 2) / np.mean(ref ** 2))
    assert rel < 0.05, rel


@pytest.mark.parametrize("activation", ["gtu", "glu", "gfu", "gsu"])
def test_gates_match_jax(activation):
    rng = np.random.RandomState(4)
    a, s = rng.randn(2, 16, 4).astype(np.float32) * 2, rng.randn(2, 16, 4).astype(np.float32) * 2
    got = gate(activation, torch.from_numpy(a), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_gate(activation, jnp.asarray(a), jnp.asarray(s))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("activation", ["gtu", "gsu"])
def test_wavenet_module_matches_jax(activation, no_kernel_build):
    """WaveNetAE at small width (start, shared upsampled conditioning, the
    stack, end) against the JAX module's plain conv path, 5e-5."""
    kw = dict(n_channels=16, n_layers=12, kernel_size=3, n_out_channels=8, max_log2_dilation_rate=7,
              cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4, activation=activation)
    jnet = JaxWaveNetAE(name="wn", **kw)
    rng = np.random.RandomState(5)
    B, T, Cin, Tm = 2, 128, 7, 16
    audio = rng.randn(B, T, Cin).astype(np.float32) * 0.3
    mel = rng.randn(B, Tm, 10).astype(np.float32) * 0.3
    params, _ = jnet.init(jax.random.PRNGKey(0), ((B, T, Cin), (B, Tm, 10)))
    params = jax_fold(params)
    ref = jnet(params, (jnp.asarray(audio), jnp.asarray(mel)))
    tnet = WaveNetAE(Cin, 10, name="wn", **kw)
    assert tnet.dilations == list(REGISTRY_DILS)
    tnet.load_state_dict(params_from_jax(flatten(params)), strict=True)
    with torch.no_grad():
        got = tnet(torch.from_numpy(audio), torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-5, atol=5e-5)
    # the cached stack weights follow a reload (in-place copy) of the params
    cached = tnet.stack_weights(torch.float32)[0][0].clone()
    state = {k: v * 0.5 for k, v in tnet.state_dict().items()}
    tnet.load_state_dict(state)
    torch.testing.assert_close(tnet.stack_weights(torch.float32)[0][0], cached * 0.5)


@pytest.fixture(scope="module")
def registry_oscillator():
    """SPEECH's (513, 13) tables (from weights.npz) and grid constants."""
    path = get_config_file("SPEECH")
    cfg = read_config(path)["mbexwn_config"]["wavetable_config"]
    spec = build_wavetable_grid(sample_rate=12000.0, **cfg)
    tables = load_params(path.replace("config.yaml", "weights.npz"))["wavetables"]
    assert tables.shape == (513, 13) and tables.dtype == np.float32
    return tables, spec


def test_k2_plain_matches_pallas_oscillator(registry_oscillator, no_kernel_build):
    tables, spec = registry_oscillator
    T = 6000
    f0 = (40.0 * (600.0 / 40.0) ** np.linspace(0, 1, 2 * T)).reshape(2, T).astype(np.float32)
    phase = np.asarray(josc.stable_cumsum_and_wrap(jnp.asarray(f0) / spec.sample_rate))
    consts = (spec.nominalF0, spec.F0GridFactor, spec.min_transposition, spec.max_transposition)
    ref = oscillator_fused(jnp.asarray(phase), jnp.asarray(f0), jnp.asarray(tables), *consts, interpret=True)
    got = tosc.oscillator_plain(torch.from_numpy(phase.copy()), torch.from_numpy(f0), torch.from_numpy(tables),
                                *consts)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # and against the JAX package's default tent-matmul path
    ref_xla = josc.grid_crossfade(josc.wavetable_lookup(jnp.asarray(phase), jnp.asarray(tables)),
                                  jnp.asarray(f0), *consts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_xla), rtol=1e-5, atol=1e-5)


def test_k2_lookup_and_crossfade_match_jax(registry_oscillator):
    tables, spec = registry_oscillator
    rng = np.random.RandomState(6)
    phase = rng.rand(2, 3000).astype(np.float32)
    phase[0, :3] = [0.0, 0.5, 511.0 / 512.0]
    f0 = rng.uniform(20.0, 900.0, (2, 3000)).astype(np.float32)
    grid = tosc.wavetable_lookup(torch.from_numpy(phase), torch.from_numpy(tables))
    jgrid = josc.wavetable_lookup(jnp.asarray(phase), jnp.asarray(tables))
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), rtol=1e-5, atol=1e-5)
    consts = (spec.nominalF0, spec.F0GridFactor, spec.min_transposition, spec.max_transposition)
    got = tosc.grid_crossfade(grid, torch.from_numpy(f0), *consts)
    np.testing.assert_allclose(got.numpy(), np.asarray(josc.grid_crossfade(jgrid, jnp.asarray(f0), *consts)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [999, 1000, 12_000])
def test_stable_cumsum_and_wrap_matches_jax(T):
    """Chunk 1000 with mod-1 carried offsets, up to one second at the 12 kHz
    pulse rate; compared wrap-aware, min(|d|, 1-|d|) <= 1e-5, since a value
    just below 1 may come out just above 0 in the other framework.  (Both
    frameworks' fp32 rounding grows with the number of chunks: at 76,800
    samples they differ by ~2e-5, which the full-synthesis budgets cover.)"""
    rng = np.random.RandomState(T)
    f0 = rng.uniform(40.0, 600.0, (2, T)).astype(np.float32)
    got = tosc.stable_cumsum_and_wrap(torch.from_numpy(f0) / 12000.0).numpy()
    ref = np.asarray(josc.stable_cumsum_and_wrap(jnp.asarray(f0) / 12000.0))
    assert got.shape == ref.shape and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - ref)
    assert np.max(np.minimum(d, 1.0 - d)) <= 1e-5


@pytest.mark.parametrize("B,T,with_offset", [(2, 6000, False), (3, 12_345, True)])
def test_oscillate_plain_matches_jax(registry_oscillator, B, T, with_offset, no_kernel_build):
    """The whole stage against jitted JAX's phase and the Pallas kernel
    (interpret mode).  rel-RMS <= 1e-4: the frameworks still sum the phase in
    another fp32 order (JAX's cumsum accumulates in fp32)."""
    tables, spec = registry_oscillator
    rng = np.random.RandomState(B * T)
    f0 = (40.0 * (600.0 / 40.0) ** rng.rand(B, T)).astype(np.float32)
    offset = rng.rand(B).astype(np.float32) if with_offset else None
    consts = (spec.nominalF0, spec.F0GridFactor, spec.min_transposition, spec.max_transposition)
    phase = jax.jit(lambda x: josc.stable_cumsum_and_wrap(x / spec.sample_rate))(jnp.asarray(f0))
    if with_offset:
        phase = jnp.mod(phase + jnp.asarray(offset)[:, None], 1.0)
    ref = np.asarray(oscillator_fused(phase, jnp.asarray(f0), jnp.asarray(tables), *consts, interpret=True))
    got, got_phase = tosc.oscillate(torch.from_numpy(f0), torch.from_numpy(tables), *consts, spec.sample_rate,
                                    phase_offset=None if offset is None else torch.from_numpy(offset),
                                    return_phase=True)
    assert got.shape == ref.shape and got_phase.shape == ref.shape
    rel = np.sqrt(np.mean((got.numpy() - ref) ** 2) / np.mean(ref ** 2))
    assert rel <= 1e-4, rel
    d = np.abs(got_phase.numpy() - np.asarray(phase))
    assert np.max(np.minimum(d, 1.0 - d)) <= 5e-5
    torch.testing.assert_close(tosc.oscillate(torch.from_numpy(f0), torch.from_numpy(tables), *consts,
                                              spec.sample_rate, phase_offset=None if offset is None else
                                              torch.from_numpy(offset)), got, rtol=0, atol=0)


def _former_stable_cumsum_and_wrap(velocity, chunk_size=1000):
    """The formula as it stood with fp32 cumsums (dtype left to PyTorch)."""
    n_batch, n_time = velocity.shape
    remainder = n_time % chunk_size
    if remainder:
        velocity = torch.nn.functional.pad(velocity, (0, chunk_size - remainder))
    chunks = velocity.reshape(n_batch, -1, chunk_size)
    phase = torch.cumsum(chunks, dim=2)
    offsets = torch.remainder(phase[:, :, -1:], 1.0)
    offsets = torch.nn.functional.pad(offsets, (0, 0, 1, 0))[:, :-1]
    offsets = torch.remainder(torch.cumsum(offsets, dim=1), 1.0)
    return torch.remainder(phase + offsets, 1.0).reshape(n_batch, -1)[:, :n_time]


@pytest.mark.parametrize("T", [999, 1000, 12_345])
def test_stable_cumsum_and_wrap_fp64_same_as_fp32_dtype_on_cpu(T):
    """On the CPU, an fp32 cumsum already accumulates in fp64: taking both
    cumsums with dtype=float64 changes no bit of the phase there."""
    rng = np.random.RandomState(T + 1)
    f0 = torch.from_numpy(rng.uniform(40.0, 600.0, (2, T)).astype(np.float32))
    v = tosc.phase_velocity(f0, 12000.0)
    assert torch.equal(tosc.stable_cumsum_and_wrap(v), _former_stable_cumsum_and_wrap(v))


def _wrap(x):
    """torch.remainder(x, 1) in fp32: fmod, then a negative result moved up by one."""
    m = np.fmod(x, np.float32(1.0))
    return np.where(m < 0, m + np.float32(1.0), m).astype(np.float32)


def _blocked_phase(f0, sample_rate, chunk=1000, seg=32):
    """The phase as the CUDA kernel orders its sums: each chunk scanned in
    fp64 as 32-element segments whose totals are scanned and added back; the
    chunk totals of a row summed in reverse order; every rounding to fp32 and
    every wrap where stable_cumsum_and_wrap has them."""
    v = f0 * np.float32(1.0 / sample_rate)
    B, T = v.shape
    n = -(-T // chunk)
    width = -(-chunk // seg) * seg
    x = np.zeros((B, n, width))
    x[:, :, :chunk] = np.pad(v, ((0, 0), (0, n * chunk - T))).reshape(B, n, chunk)
    local = np.cumsum(x.reshape(B, n, -1, seg), axis=-1)
    seg_tot = local[..., -1]
    seg_before = np.concatenate([np.zeros((B, n, 1)), np.cumsum(seg_tot, axis=-1)[..., :-1]], axis=-1)
    prefix = (local + seg_before[..., None]).reshape(B, n, width)[..., :chunk]
    s32 = prefix.astype(np.float32)
    rem = _wrap(prefix[..., chunk - 1].astype(np.float32))
    prior = np.zeros((B, n))
    for c in range(n):
        for k in reversed(range(c)):
            prior[:, c] += rem[:, k]
    off = _wrap(prior.astype(np.float32))
    phase = _wrap(s32 + off[..., None])
    return phase.reshape(B, n * chunk)[:, :T]


@pytest.mark.parametrize("T", [1000, 12_345])
def test_phase_is_the_same_in_any_summation_order(T):
    """Every partial sum is exact in fp64 for F0 in 1 Hz - 2 kHz, so the
    kernel's blocked parallel order gives stable_cumsum_and_wrap's phase bit
    for bit."""
    rng = np.random.RandomState(T + 2)
    f0 = np.exp(rng.uniform(0.0, np.log(2000.0), (2, T))).astype(np.float32)
    f0[0, :50] = 1.0
    f0[1, -50:] = 2000.0
    got = _blocked_phase(f0, 12000.0)
    ref = tosc.stable_cumsum_and_wrap(tosc.phase_velocity(torch.from_numpy(f0), 12000.0)).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_phase_velocity_matches_jitted_jax():
    """F0 / 12 kHz: jitted JAX multiplies by the fp32 reciprocal, as the port
    does (eager division differs in the last bit)."""
    rng = np.random.RandomState(7)
    f0 = np.concatenate([rng.uniform(1.0, 2000.0, 100_000), np.arange(1, 24_001) * 0.5]).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: x / 12000.0)(jnp.asarray(f0)))
    got = tosc.phase_velocity(torch.from_numpy(f0), 12000.0).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, ref)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 2, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        wavenet_stack(x, torch.zeros(1, 4, 4, device="meta"), [], [])
    with pytest.raises(RuntimeError, match="unsupported device"):
        tosc.oscillate(torch.zeros(1, 4, device="meta"), torch.zeros(3, 2, device="meta"), 50.0, 1.25, 1.0, 2.0,
                       12000.0)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tosc.oscillate(torch.zeros(1, 4, device="meta"), torch.zeros(3, 2, device="meta"), 50.0, 1.25, 1.0, 2.0,
                       12000.0, phase_offset=torch.zeros(1, device="meta"), return_phase=True)


# ---- the kernel's operand layout: reduction dimension padded with zeros to a multiple of 64

from mbexwn_vocoder_torch.ops.wavenet_stack import PackedStackWeights, pack_stack_weights, padded_channels


def test_padded_channels():
    assert [padded_channels(c) for c in (8, 64, 320, 340, 384, 385)] == [64, 64, 320, 384, 384, 448]


@pytest.mark.parametrize("C", [320, 340])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_weights_padded_layout(C, dtype):
    """WaveNetAE.stack_weights at the registry's two widths: (2C, 3, Cp) and
    (Cout, Cp), contiguous, zeros in the pad, and the unpadded part bit-equal
    to the (2C, 3, C) / (Cout, C) re-layout of the conv parameters."""
    torch.manual_seed(C)
    net = WaveNetAE(5, 6, n_channels=C, n_layers=2, kernel_size=3, n_out_channels=4, max_log2_dilation_rate=7,
                    cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4)
    packed = net.stack_weights(dtype)
    Cp = padded_channels(C)
    assert isinstance(packed, PackedStackWeights) and (packed.C, packed.C_pad, len(packed)) == (C, Cp, 2)
    assert packed.dtype == dtype
    for i, (wd, bd, wr, br) in enumerate(packed):
        conv, rs = getattr(net, f"conv1D_{i}"), getattr(net, f"res_skip_{i}")
        n_rs = 2 * C if i == 0 else C  # the last layer is skip-only
        assert tuple(wd.shape) == (2 * C, 3, Cp) and tuple(wr.shape) == (n_rs, Cp)
        assert tuple(bd.shape) == (2 * C,) and tuple(br.shape) == (n_rs,)
        assert all(t.is_contiguous() and t.dtype == dtype for t in (wd, bd, wr, br))
        assert not wd[..., C:].any() and not wr[..., C:].any()
        assert torch.equal(wd[..., :C], conv.weight.detach().permute(0, 2, 1).to(dtype))
        assert torch.equal(wr[..., :C], rs.weight.detach()[:, :, 0].to(dtype))
        assert torch.equal(bd, conv.bias.detach().to(dtype)) and torch.equal(br, rs.bias.detach().to(dtype))


def test_stack_weights_cache_follows_the_parameters():
    """The packed weights are kept between calls and rebuilt when a
    parameter changes in place (its version counter) or the dtype does."""
    net = WaveNetAE(5, 6, n_channels=12, n_layers=3, kernel_size=3, n_out_channels=4, max_log2_dilation_rate=7,
                    cond_kernel_size=3, cond_conv_upsampling=2, cond_lin_upsampling=4)
    first = net.stack_weights(torch.float32)
    assert net.stack_weights(torch.float32) is first
    assert net.stack_weights(torch.bfloat16) is not first
    first = net.stack_weights(torch.float32)
    before = first[1][2].clone()
    with torch.no_grad():
        net.res_skip_1.bias.add_(1.0)  # touches the version of one parameter only
        net.res_skip_1.weight.mul_(2.0)
    second = net.stack_weights(torch.float32)
    assert second is not first
    torch.testing.assert_close(second[1][2], before * 2.0, rtol=0, atol=0)
    assert not second[1][2][:, 12:].any()


@pytest.mark.parametrize("C", [8, 20])
def test_k1_plain_same_on_padded_operands(C, no_kernel_build):
    """The plain version on the kernel layout (x (B, T, Cp), packed weights)
    gives the very skip sum it gives on unpadded operands (it reads the first
    C columns only), and multiplying the zero pad, as the kernel does, gives
    the same up to fp32 summation order.  On the padded operands it still
    matches the Pallas stack."""
    rng = np.random.RandomState(7)
    x, cond, weights = _stack_case(rng, 2, 512, C, REGISTRY_DILS)
    tw = _torch_weights(weights)
    packed = pack_stack_weights(tw)
    Cp = padded_channels(C)
    assert packed.C_pad == Cp == 64 and tuple(packed[0][0].shape) == (2 * C, 3, Cp)
    x_pad = torch.nn.functional.pad(torch.from_numpy(x), (0, Cp - C))
    plain = wavenet_stack_plain(torch.from_numpy(x), torch.from_numpy(cond), tw, REGISTRY_DILS)
    for xin in (x_pad, torch.from_numpy(x)):
        padded = wavenet_stack(xin, torch.from_numpy(cond), packed, REGISTRY_DILS)
        assert tuple(padded.shape) == (2, 512, C) and padded.dtype == torch.float32
        assert torch.equal(padded, plain)
    # the same function at width Cp, with the pad really multiplied: zero rows and columns
    # in every weight and bias, cond's halves moved to columns 0 and Cp
    pad = torch.nn.functional.pad

    def pad_halves(t, spec):  # each C-row half of t padded on its own
        return torch.cat([pad(t[k:k + C], spec) for k in range(0, t.shape[0], C)])

    wide = [(pad_halves(wd, (0, 0, 0, 0, 0, Cp - C)), pad_halves(bd, (0, Cp - C)),
             pad_halves(wr, (0, 0, 0, Cp - C)), pad_halves(br, (0, Cp - C))) for wd, bd, wr, br in packed]
    c = torch.from_numpy(cond)
    cond_wide = torch.cat([pad(c[..., :C], (0, Cp - C)), pad(c[..., C:], (0, Cp - C))], -1)
    multiplied = wavenet_stack_plain(x_pad, cond_wide, wide, REGISTRY_DILS)
    assert tuple(multiplied.shape) == (2, 512, Cp) and not multiplied[..., C:].any()
    torch.testing.assert_close(multiplied[..., :C], plain, rtol=1e-5, atol=1e-5)
    ref = fused_wavenet_stack(jnp.asarray(x), jnp.asarray(cond),
                              [tuple(jnp.asarray(w) for w in lw) for lw in weights],
                              REGISTRY_DILS, group_size=4, interpret=True)
    np.testing.assert_allclose(padded.numpy(), np.asarray(ref), rtol=5e-5, atol=5e-5)


def test_k1_plain_padded_bf16_matches_unpadded(no_kernel_build):
    """In bf16 too: x and the gated activation round at the same points
    whether or not the operands carry the pad."""
    rng = np.random.RandomState(8)
    dils = (1, 2, 4, 8)
    x, cond, weights = _stack_case(rng, 1, 128, 12, dils)
    wb = _torch_weights(weights, torch.bfloat16)
    xb, cb = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(cond).to(torch.bfloat16)
    assert torch.equal(wavenet_stack_plain(xb, cb, pack_stack_weights(wb), dils), wavenet_stack_plain(xb, cb, wb, dils))


def test_pack_stack_weights_refuses_mismatched_layers():
    rng = np.random.RandomState(9)
    _, _, weights = _stack_case(rng, 1, 8, 8, (1, 2))
    tw = _torch_weights(weights)
    with pytest.raises(ValueError, match="w_rs"):
        pack_stack_weights([tw[0], (tw[1][0], tw[1][1], tw[1][2][:, :4], tw[1][3])])
    with pytest.raises(ValueError, match="at least one layer"):
        pack_stack_weights([])
    with pytest.raises(ValueError, match="cond implies"):
        wavenet_stack_plain(torch.zeros(1, 8, 7), torch.zeros(1, 8, 16), pack_stack_weights(tw), (1, 2))
