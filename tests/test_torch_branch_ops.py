"""The pieces of the model's opt-in branches against the JAX package, on
the CPU: the pulse-synchronous gain scans and `oscillate_with_pulse_gains`,
NormMelComponents' options, the PReLU / LeakyReLU layers and the post-gain
conv, the envelope's aux losses through the trainer (fp64 loss and
gradients), and the public helpers `get_list_parameter` and
`design_prototype_filter_differentiable`.

Bounds: the hold scans bit-equal on a phase made in numpy and handed to
both; the pulse averages 1e-6 relative (JAX's fp32 cumsum loses more with
the length, so the long case holds the port's fp64 cumsum to exact
segment means at 1e-7 instead); NormMel 1e-5 relative; the
aux losses' fp64 loss 1e-12 and every gradient leaf 1e-7 rel-RMS, as
tests/test_torch_training.py holds the trainer; the helpers exact, the
filter design 1e-6.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu import nn as jnn
from mbexwn_vocoder_tpu.config import get_list_parameter as jax_get_list_parameter
from mbexwn_vocoder_tpu.dsp.pqmf import design_prototype_filter_differentiable as jax_design
from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.models.pan_wavenet import NormMelComponents as JaxNormMel
from mbexwn_vocoder_tpu.ops import oscillator as jax_osc
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.training import Trainer as JaxTrainer

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.config import get_list_parameter, read_config
from mbexwn_vocoder_torch.dsp.pqmf import design_prototype_filter, design_prototype_filter_differentiable
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.models.pan_wavenet import NormMelComponents
from mbexwn_vocoder_torch.nn.layers import Conv1DWeightNorm, LeakyReLU, PReLU
from mbexwn_vocoder_torch.ops import oscillator as osc
from mbexwn_vocoder_torch.training.parity import hold_leaves, tiny_batch, tiny_hparams

from tests.test_torch_config_branches import _small_hparams
from tests.test_torch_model import rel_rms
from tests.test_torch_training import jax_draws, jax_fp64, jax_params, port_trainer  # noqa: F401 (fixture)

torch.set_num_threads(2)


def _phase_and_gain(T, B=3, seed=0):
    """A wrapped phase of F0 100-180 Hz at 12 kHz and a gain contour."""
    rng = np.random.RandomState(seed)
    f0 = (100 + 80 * rng.rand(B, T)).astype(np.float32)
    phase = np.mod(np.cumsum(f0 / 12000.0, axis=1), 1.0).astype(np.float32)
    return phase, (1 + 0.5 * rng.randn(B, T)).astype(np.float32)


def test_hold_last_and_pulse_start_mask_equal_jax():
    phase, gain = _phase_and_gain(400)
    mask = np.asarray(jax_osc.pulse_start_mask(jnp.asarray(phase)))
    got = osc.pulse_start_mask(torch.from_numpy(phase)).numpy()
    assert np.array_equal(got, mask) and got[:, 0].all() and got.sum() > 3 * 4
    mask0 = np.random.RandomState(1).rand(*mask.shape) < 0.3
    mask0[0] = True  # every column marked at its first row
    for axis, m in ((-1, mask), (0, mask0)):
        ref = np.asarray(jax_osc.hold_last(jnp.asarray(gain), jnp.asarray(m), axis=axis))
        assert np.array_equal(osc.hold_last(torch.from_numpy(gain), torch.from_numpy(np.array(m)), axis=axis).numpy(), ref)


@pytest.mark.parametrize("T", [400, 2000])
def test_pulse_sync_gains_equal_jax(T):
    phase, gain = _phase_and_gain(T)
    args_j, args_t = (jnp.asarray(phase), jnp.asarray(gain)), (torch.from_numpy(phase), torch.from_numpy(gain))
    hold = osc.pulse_sync_gain_hold(*args_t).numpy()
    assert np.array_equal(hold, np.asarray(jax.jit(jax_osc.pulse_sync_gain_hold)(*args_j)))
    avg = osc.pulse_sync_gain_avg(*args_t).numpy()
    ref = np.asarray(jax.jit(jax_osc.pulse_sync_gain_avg)(*args_j))
    assert rel_rms(avg, ref) <= 1e-6, rel_rms(avg, ref)


def _segment_means(phase, gain):
    """The reference's per-pulse means in fp64 numpy, segment by segment."""
    out = np.empty(gain.shape, np.float64)
    for row, (p, g) in enumerate(zip(phase, gain.astype(np.float64))):
        ends = list(np.nonzero(p[:-1] > p[1:])[0] + 1) + [len(p)]
        lo = 0
        for hi in ends:
            out[row, lo:hi] = g[lo:hi].mean()
            lo = hi
    return out


def test_pulse_sync_gain_avg_sums_in_fp64():
    """At 2 s of pulse-rate samples an fp32 cumsum (JAX's) moves the
    averages ~1e-5 from the exact segment means; the port's fp64 cumsum
    keeps them to fp32 rounding."""
    phase, gain = _phase_and_gain(24000)
    exact = _segment_means(phase, gain)
    port = osc.pulse_sync_gain_avg(torch.from_numpy(phase), torch.from_numpy(gain)).numpy()
    ref = np.asarray(jax.jit(jax_osc.pulse_sync_gain_avg)(jnp.asarray(phase), jnp.asarray(gain)))
    assert rel_rms(port, exact) <= 1e-7 < rel_rms(ref, exact), (rel_rms(port, exact), rel_rms(ref, exact))


@pytest.fixture(scope="module")
def pulse_models():
    hp = _small_hparams(lambda mc: None)
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jax_fold(jmodel.init(jax.random.PRNGKey(5), batch_size=2, T_mel=8))
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)
    return jmodel.block, params, model.block


@pytest.mark.parametrize("avg", [False, True])
@pytest.mark.parametrize("return_gain", [False, True])
def test_oscillate_with_pulse_gains_matches_jax(pulse_models, avg, return_gain):
    """Hold and average, with and without `return_gain`, a None entry
    passing through, and a phase offset: pulses within 1e-4 rel-RMS (the
    phase sums differ: fp32 in JAX, fp64 in the port) and gains within
    1e-6."""
    jblk, params, blk = pulse_models
    rng = np.random.RandomState(4)
    f0 = (110 + 60 * rng.rand(2, 1200)).astype(np.float32)
    gains = [(1 + 0.3 * rng.randn(2, 1200)).astype(np.float32), None]
    offset = np.asarray([0.3, 0.7], np.float32)
    ref = jblk.oscillate_with_pulse_gains(params, jnp.asarray(f0), [None if g is None else jnp.asarray(g)
                                                                    for g in gains],
                                          pulse_sync_gain_avg=avg, return_gain=return_gain,
                                          phase_offset=jnp.asarray(offset))
    with torch.no_grad():
        got = blk.oscillate_with_pulse_gains(torch.from_numpy(f0), [None if g is None else torch.from_numpy(g)
                                                                    for g in gains],
                                             pulse_sync_gain_avg=avg, return_gain=return_gain,
                                             phase_offset=torch.from_numpy(offset))
    if return_gain:
        (audio, gain), (j_audio, j_gain) = got, ref
        assert len(audio) == len(j_audio) == 1 and gain[1] is None and j_gain[1] is None
        assert rel_rms(audio[0], j_audio[0]) <= 1e-4 and rel_rms(gain[0], j_gain[0]) <= 1e-6
    else:
        assert len(got) == 2 and got[1] is None and ref[1] is None
        assert rel_rms(got[0], ref[0]) <= 1e-4, rel_rms(got[0], ref[0])


NORMMEL_OPTIONS = {
    "plain": {},
    "pinv": dict(normalize_use_pinv=True),
    "max_norm_fact": dict(max_norm_fact=30.0),
    "compressor_exp": dict(normalize_compressor_exp=0.5),
    "use_max_limit": dict(use_max_limit=True, lin_amp_off=1e-3),
    "amp_scales": dict(lin_amp_scale=2.0, mel_amp_scale=0.5),
    "smoothing": dict(normalize_rms_num_smooth_iters=2),
    "smoothing_wide_window": dict(normalize_rms_num_smooth_iters=1, normalize_smooth_win_scale=1.5,
                                  normalize_smooth_with_squared_win=False),
    "smoothing_and_pinv": dict(normalize_rms_num_smooth_iters=3, normalize_use_pinv=True),
}


@pytest.mark.parametrize("option", list(NORMMEL_OPTIONS))
@pytest.mark.parametrize("n_group", [1, 2])
def test_normmel_matches_jax(option, n_group):
    """The synthesis form (audio None) and the training form (audio in,
    grouped by n_group) of `normalize_inputs_by_rms`."""
    pc = read_config(get_config_file("SPEECH"))["preprocess_config"]
    kw = dict(NORMMEL_OPTIONS[option], n_group=n_group)
    rng = np.random.RandomState(6)
    mell = (rng.randn(2, 12, 80) * 0.8 - 4 + np.linspace(-3, 2, 12)[None, :, None]).astype(np.float32)
    audio = (rng.randn(2, 12 * 300) * 0.1).astype(np.float32)
    jnorm, norm = JaxNormMel(pc, **kw), NormMelComponents(pc, **kw)
    for a in (None, audio):
        ref = jnorm.normalize_inputs_by_rms(None if a is None else jnp.asarray(a), jnp.asarray(mell), 12 * 300)
        got = norm.normalize_inputs_by_rms(None if a is None else torch.from_numpy(a), torch.from_numpy(mell),
                                           12 * 300)
        assert (got[0] is None) == (ref[0] is None)
        for g, r in zip(got, ref):
            if r is not None:
                assert tuple(g.shape) == r.shape and rel_rms(g, r) <= 1e-5, (option, rel_rms(g, r))


def test_activation_layers_match_jax():
    x = np.random.RandomState(2).randn(2, 10, 4).astype(np.float32)
    prelu = PReLU(0.1, channels=4)
    with torch.no_grad():
        prelu.alpha.copy_(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    jprelu = jnn.layers.PReLU(0.1)
    ref = np.asarray(jprelu({"alpha": jnp.asarray([0.1, 0.2, 0.3, 0.4])}, jnp.asarray(x)))
    assert np.array_equal(prelu(torch.from_numpy(x)).detach().numpy(), ref)
    ref = np.asarray(jnn.layers.LeakyReLU(0.3)({}, jnp.asarray(x)))
    assert np.allclose(LeakyReLU(0.3)(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=1e-7)


def test_post_gain_conv_matches_jax():
    """Equalized LR without weight norm, JAX's {kernel, g, b}: loaded by
    `params_from_jax`, g * conv(x, kernel) + b, and the init's kernel / rms
    with g = rms."""
    jconv = jnn.Conv1DWeightNorm(6, 3, dilation_rate=2, use_weight_norm=False, use_equalized_lr=True)
    params, _ = jconv.init(jax.random.PRNGKey(1), (2, 20, 4))
    assert set(params) == {"kernel", "g", "b"}
    rng = np.random.RandomState(3)
    params = {"kernel": params["kernel"], "g": params["g"] * (1 + rng.rand(6).astype(np.float32)),
              "b": jnp.asarray(rng.randn(6).astype(np.float32))}
    conv = Conv1DWeightNorm(4, 6, 3, dilation_rate=2, use_weight_norm=False, use_equalized_lr=True)
    conv.load_state_dict(params_from_jax(flatten(params)), strict=True)
    x = rng.randn(2, 20, 4).astype(np.float32)
    ref = np.asarray(jconv(params, jnp.asarray(x)))
    with torch.no_grad():
        assert rel_rms(conv(torch.from_numpy(x)), ref) <= 1e-6
    conv.init(torch.Generator().manual_seed(0))
    k = conv.weight.detach()
    assert abs(float(torch.sqrt(torch.mean(k * k))) - 1) < 1e-5 and torch.all(conv.g == conv.g[0])


def test_envelope_aux_losses_match_jax_fp64(jax_params, monkeypatch):
    """The cepstral-loss constraint and energy preservation with a gain-loss
    weight: both aux losses enter the trainer's loss with their weights, as
    the JAX trainer adds them; fp64 loss within 1e-12 and every leaf of the
    gradient within 1e-7 rel-RMS of JAX's fp64 `Trainer.loss_fn`, and the
    fp32 metrics are JAX's."""
    hp = tiny_hparams(**{"mbexwn_config.psns_use_cepstral_loss_constraint": True,
                         "mbexwn_config.spect_filters_preserve_energy": True,
                         "mbexwn_config.psns_gain_loss_weight": 0.3})
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "0")
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    jtr = JaxTrainer(jmodel, copy.deepcopy(hp))
    batch = tiny_batch()
    key = jax.random.PRNGKey(3)
    _, j_metrics = jax.jit(jtr.loss_fn)(jax_params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(0),
                                        key)
    j_loss64, exact = jax_fp64(monkeypatch, hp, jax_params, batch, key)
    tr = port_trainer(hp, jax_params)
    draws = jax_draws(jtr, key, tr.draw_shapes(batch))
    _, metrics, _ = tr.value_and_grad(batch, 0, draws)
    loss64, _, grads64 = port_trainer(hp, jax_params, torch.float64).value_and_grad(batch, 0, draws)
    assert {"PS_cepstral_loss", "PS_gain_loss"} <= set(metrics) and set(metrics) == set(j_metrics)
    for name in ("PS_cepstral_loss", "PS_gain_loss", "total_loss"):
        assert abs(float(metrics[name]) / float(j_metrics[name]) - 1) <= 1e-5, (name, metrics[name])
    assert abs(float(loss64) / j_loss64 - 1) <= 1e-12, (float(loss64), j_loss64)
    bad, rows = hold_leaves(grads64, exact, 1e-7)
    assert not bad, bad


def test_get_list_parameter_matches_jax():
    cases = [((3, 4), {}), (([1, 2], 4), dict(n_repeater=2)), (([1, 2, 3, 4], 4), {}), (([1, 2], 5), dict(n_repeater=2)),
             (([1, 2], 3), dict(n_repeater_list=[1, 2]))]
    for args, kw in cases:
        assert get_list_parameter(*args, **kw) == jax_get_list_parameter(*args, **kw)
    assert get_list_parameter(3, 4) == [3, 3, 3, 3]
    assert get_list_parameter([1, 2], 4, n_repeater=2) == [1, 1, 2, 2]
    assert get_list_parameter([1, 2, 3, 4], 4) == [1, 2, 3, 4]
    for args, kw in ((([1, 2, 3], 4), {}), (([1, 2], 4), dict(n_repeater=1, n_repeater_list=[2, 2]))):
        with pytest.raises(RuntimeError):
            get_list_parameter(*args, **kw)


def test_differentiable_prototype_filter_matches_jax():
    """Values against the numpy design and JAX's, and the gradient of the
    filter's energy with respect to the cutoff against `jax.grad`."""
    h = design_prototype_filter_differentiable(torch.tensor(0.15), 62, 9.0)
    ref = np.asarray(jax_design(jnp.float32(0.15), 62, 9.0))
    assert h.dtype == torch.float32 and rel_rms(h, ref) <= 1e-6
    assert rel_rms(h, design_prototype_filter(62, 0.15, 9.0)) <= 1e-6
    c = torch.tensor(0.15, requires_grad=True)
    (design_prototype_filter_differentiable(c, 62, 9.0) ** 2).sum().backward()
    g = float(jax.grad(lambda c: jnp.sum(jax_design(c, 62, 9.0) ** 2))(jnp.float32(0.15)))
    assert g != 0 and abs(float(c.grad) / g - 1) <= 1e-6, (float(c.grad), g)
