"""The port's training losses against the JAX package's, on the same audio
pair, fp32: the multi-resolution spectral and NPOW losses and the mel loss
(SPEECH's training config, and variants: a variants dimension, mean
removal, masking noises handed over from the JAX key, low-band weighting,
magnitude compression), both F0 masks exactly, the F0 prediction loss in
L1/L2/RMSE with and without a UV weight, and the STFT coherence loss.
Bound 1e-5 relative."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mbexwn_vocoder_tpu as mv
from mbexwn_vocoder_tpu.config import read_config as jax_read_config
from mbexwn_vocoder_tpu.ops.stft_ops import inverse_stft_window as jax_istft_window
from mbexwn_vocoder_tpu.training import losses as jl

from mbexwn_vocoder_torch.dsp.windows import hann_periodic
from mbexwn_vocoder_torch.ops.stft_ops import inverse_stft_window, stft
from mbexwn_vocoder_torch.training import losses as tl

torch.set_num_threads(2)
B, T = 2, 4800


def rel(got, ref):
    return abs(float(got) / float(ref) - 1)


@pytest.fixture(scope="module")
def configs():
    hp = jax_read_config(mv.get_config_file("SPEECH"))
    return hp["training_config"], hp["preprocess_config"]


@pytest.fixture(scope="module")
def audio_pair():
    """A decaying two-partial tone plus noise, and a distorted copy of it."""
    rng = np.random.RandomState(0)
    t = np.arange(T) / 24000.0
    ref = (0.3 * np.sin(2 * np.pi * 180 * t) * np.exp(-t * 3) + 0.1 * np.sin(2 * np.pi * 1230 * t)
           + 0.05 * rng.randn(B, T)).astype(np.float32)
    gen = (0.8 * ref + 0.04 * rng.randn(B, T) + 0.02 * np.roll(ref, 7, axis=1)).astype(np.float32)
    return ref, gen


SPECT_VARIANTS = {
    "registry": {},
    "mean removal, low-band weight": {"remove_mean_hz": 50.0, "low_band_extra_weight": 2.0,
                                      "low_band_extra_weight_limit_Hz": 300, "low_band_extra_weight_transition_Hz": 200},
    "masking noises": {"masking_noise_std": 1e-3, "rel_masking_noise_atten_db": 30.0},
    "magnitude compression, relative offset": {"magnitude_compression": 0.3, "use_lin_amp_off_for_mc": True,
                                               "rel_lin_amp_off": True, "fft_over": 1},
}


@pytest.mark.parametrize("variant", list(SPECT_VARIANTS))
def test_spect_npow_mel_losses_match_jax(configs, audio_pair, variant):
    tc, pc = copy.deepcopy(configs[0]), configs[1]
    tc["spect_loss_config"].update(SPECT_VARIANTS[variant])
    ref, gen = audio_pair
    ours, theirs = tl.SpectLossComponents(tc, pc), jl.SpectLossComponents(tc, pc)
    key = jax.random.PRNGKey(11)
    noises, k = {}, key
    for name in ours.masking_draws:  # the JAX package's split order (losses.py: rel masking, then masking)
        k, sub = jax.random.split(k)
        noises[name] = torch.from_numpy(np.array(jax.random.normal(sub, (B, T))))
    got = ours.calc_losses(torch.from_numpy(ref), torch.from_numpy(gen), noises=noises)
    exp = theirs.calc_losses(jnp.asarray(ref), jnp.asarray(gen), rng=key)
    assert set(k for k, v in got.items() if v is not None) == {"spect_loss", "NPOW_loss", "mel_loss"}
    for name, value in got.items():
        assert rel(value, exp[name]) <= 1e-5, (name, float(value), float(exp[name]))
    total, _ = ours.total_loss(torch.from_numpy(ref), torch.from_numpy(gen), noises=noises)
    exp_total, _ = theirs.total_loss(jnp.asarray(ref), jnp.asarray(gen), rng=key)
    assert rel(total, exp_total) <= 1e-5


@pytest.mark.parametrize("train_with_avg", [None, 1, 3])
def test_spectral_error_with_variants_matches_jax(configs, audio_pair, train_with_avg):
    tc, pc = configs
    ref, gen = audio_pair
    gen_v = np.stack([gen, 0.9 * gen + 0.01, gen[:, ::-1].copy()], axis=1)
    got = tl.SpectLossComponents(tc, pc, train_with_avg=train_with_avg).calc_spectral_error(
        torch.from_numpy(ref), torch.from_numpy(gen_v))
    exp = jl.SpectLossComponents(tc, pc, train_with_avg=train_with_avg).calc_spectral_error(
        jnp.asarray(ref), jnp.asarray(gen_v))
    for g, e in zip(got, exp):
        assert rel(g, e) <= 1e-5, (float(g), float(e))


def _f0_target():
    rng = np.random.RandomState(3)
    f0 = (140 + 20 * rng.randn(B, 1200)).astype(np.float32)
    f0[0, 100:140] = 0
    f0[0, 700:1000] = 0
    f0[1, :50] = 0
    f0[1, 600:603] = 0
    f0[1, 1150:] = 0
    return f0


@pytest.mark.parametrize("limit", [0, 3, 60, 240])
def test_f0_masks_equal_jax(limit):
    f0 = _f0_target()
    for port, ref in ((tl.f0_pred_loss_mask, jl.f0_pred_loss_mask), (tl.f0_rec_loss_mask, jl.f0_rec_loss_mask)):
        got = port(torch.from_numpy(f0), limit).numpy()
        exp = np.asarray(ref(jnp.asarray(f0), limit))
        assert got.dtype == np.float32 and np.array_equal(got, exp), (port.__name__, limit)


@pytest.mark.parametrize("uv_weight", [None, 0.5])
@pytest.mark.parametrize("method", ["L1", "L2", "RMSE"])
def test_f0_prediction_loss_matches_jax(method, uv_weight):
    f0 = _f0_target()
    pred = (150 + 30 * np.random.RandomState(4).randn(B, 1250)).astype(np.float32)
    pm, rm = jl.f0_pred_loss_mask(jnp.asarray(f0), 24), jl.f0_rec_loss_mask(jnp.asarray(f0), 24)
    exp = jl.f0_prediction_loss(jnp.asarray(pred), jnp.asarray(f0), pm, method=method, uv_weight=uv_weight,
                                rec_mask=rm, min_frequency=40.0)
    got = tl.f0_prediction_loss(torch.from_numpy(pred), torch.from_numpy(f0), torch.from_numpy(np.array(pm)),
                                method=method, uv_weight=uv_weight, rec_mask=torch.from_numpy(np.array(rm)),
                                min_frequency=40.0)
    assert rel(got, exp) <= 1e-5, (float(got), float(exp))


def test_stft_coherence_loss_matches_jax(audio_pair):
    """On a filtered STFT (the excitation's STFT times a smooth filter), the
    model's internal geometry: window 1200, hop 300, FFT 2048."""
    win, hop, fft = 1200, 300, 2048
    ref, _ = audio_pair
    window = hann_periodic(win)
    iwin = inverse_stft_window(win, hop, window)
    np.testing.assert_array_equal(iwin, np.asarray(jax_istft_window(win, hop, window)))
    spec = stft(torch.from_numpy(np.pad(ref, ((0, 0), (win // 2, win // 2 + hop + 1)))), win, hop, fft,
                torch.from_numpy(window))
    filt = torch.exp(torch.complex(0.3 * torch.cos(torch.linspace(0, 6, fft // 2 + 1)),
                                   0.2 * torch.sin(torch.linspace(0, 9, fft // 2 + 1))))
    coh = spec * filt
    got = tl.stft_coherence_loss(coh, win, hop, fft, torch.from_numpy(iwin), torch.from_numpy(window))
    exp = jl.stft_coherence_loss(jnp.asarray(coh.numpy()), win, hop, fft, jnp.asarray(iwin), jnp.asarray(window))
    assert float(got) > 0 and rel(got, exp) <= 1e-5, (float(got), float(exp))
