"""The port's StreamingSynthesizer against the JAX package's, and the
properties the JAX package's streaming tests hold it to
(tests/test_parallel.py), on the CPU in fp32.

The model is SPEECH's config at narrow WaveNet width (16 channels, 3
layers) with the noise channel off (sigma 0) and no mel RMS normalisation,
as the JAX tests build it: every chunk call draws the same noise, so
chunked output equals one-shot output only without noise.  JAX's random
init (PRNGKey(0)), folded, is loaded into the port.  Bounds: chunked
against one-shot 2e-3 rel-RMS (the JAX tests' bound, fp32 cumsum noise),
the port's modes against the JAX package's 1e-3 rel-RMS.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.parallel import StreamingSynthesizer as JaxStreamingSynthesizer
from mbexwn_vocoder_tpu.parallel.streaming import _mod1_sum as jax_mod1_sum

from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.models import create_model, create_registry_model
from mbexwn_vocoder_torch.parallel import StreamingSynthesizer
from mbexwn_vocoder_torch.parallel.streaming import _mod1_sum

from tests.test_torch_causal import causal_small_hparams
from tests.test_torch_model import make_mel, rel_rms

torch.set_num_threads(2)
T = 96
HOP = 300


@pytest.fixture(scope="module")
def models():
    hp = causal_small_hparams(force_causal=False)
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


def test_streaming_matches_one_shot(models):
    """Chunked synthesis with the phase carry == one-shot, up to fp32 cumsum noise."""
    _, _, model = models
    mell = _mel(1)
    y_one = _one_shot(model, mell)
    y = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu").synth(mell)
    assert y.shape == y_one.shape
    assert rel_rms(y, y_one) < 2e-3


def test_streaming_long_form(models):
    """640 frames in chunks of 128: the right length, finite, and only 3
    chunk shapes (first, interior, last)."""
    _, _, model = models
    mell = _mel(2, frames=640)
    ss = StreamingSynthesizer(model, chunk_frames=128, halo_frames=24, device="cpu")
    y = ss.synth(mell)
    assert y.shape == (1, 640 * HOP)
    assert np.all(np.isfinite(y))
    assert len(ss.programs) <= 3


def test_phase_offset_continuity(models):
    """The phase_offset plumbing: the oscillator over [0, T) equals [0, T/2)
    followed by [T/2, T) started from the carried phase."""
    _, _, model = models
    blk = model.block
    f0 = (150 + 30 * np.abs(np.sin(np.linspace(0, 5, 6000)))).astype(np.float32)[None]
    full = blk.oscillate(torch.from_numpy(f0)).numpy()
    h = 3000
    a = blk.oscillate(torch.from_numpy(f0[:, :h])).numpy()
    carry = np.mod(np.sum(f0[:, :h].astype(np.float64), axis=1) / blk.pulse_rate, 1.0)
    b = blk.oscillate(torch.from_numpy(f0[:, h:].copy()), phase_offset=torch.from_numpy(carry.astype(np.float32)))
    np.testing.assert_allclose(np.concatenate([a, b.numpy()], axis=1), full, rtol=1e-3, atol=5e-3)


def test_synth_batched_matches_one_shot(models):
    """All chunks of a shape in one batched call == one-shot and == the
    sequential synth (2e-3)."""
    _, _, model = models
    mell = _mel(7)
    y_one = _one_shot(model, mell)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    y_b = ss.synth_batched(mell)
    assert y_b.shape == y_one.shape
    assert rel_rms(y_b, y_one) < 2e-3
    assert rel_rms(y_b, ss.synth(mell)) < 2e-3


def test_synth_scan_matches_one_shot(models):
    """The back-to-back chunk loop == one-shot away from the edges (the edge
    chunks see edge-replicated halo context instead of the signal
    boundary), and runs one program shape."""
    _, _, model = models
    mell = _mel(9)
    y_one = _one_shot(model, mell)
    h = 16
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=h, device="cpu")
    y = ss.synth_scan(mell)
    assert y.shape == y_one.shape and np.all(np.isfinite(y))
    lo, hi = h * HOP, (T - h) * HOP
    assert rel_rms(y[:, lo:hi], y_one[:, lo:hi]) < 2e-3
    assert sum(1 for k in ss.programs if k[0] == "scan") == 1


def test_synth_scan_matches_jax_pallas_stack(models, monkeypatch):
    """The JAX package's synth_scan with its fused Pallas WaveNet stack
    inside the loop (interpret mode, as its own test runs it), against the
    port's synth_scan, whose stack is the CUDA kernel's plain version here
    (2e-3, the JAX test's bound between its Pallas and conv stacks)."""
    jmodel, params, model = models
    mell = _mel(11)
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "1")
    ref = JaxStreamingSynthesizer(jmodel, params, chunk_frames=32, halo_frames=16).synth_scan(mell)
    got = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu").synth_scan(mell)
    assert got.shape == ref.shape
    assert rel_rms(got, ref) < 2e-3


def test_synth_batched_multi_utterance(models):
    """synth_batched with B > 1 equals the same utterances run one by one."""
    _, _, model = models
    mell = _mel(11, B=3)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    y_all = ss.synth_batched(mell)
    assert y_all.shape == (3, T * HOP)
    for b in range(3):
        np.testing.assert_allclose(y_all[b: b + 1], ss.synth_batched(mell[b: b + 1]), rtol=1e-3, atol=1e-3)


def test_f0_net_runs_once_a_chunk(models, monkeypatch):
    """synth_batched runs the F0 net once per chunk group and synthesises
    with that F0 (one F0 pass for each of its 3 groups); synth runs it once
    per chunk."""
    _, _, model = models
    blk = model.block
    calls = []
    real = blk.generate_f0
    monkeypatch.setattr(blk, "generate_f0", lambda mel: calls.append(tuple(mel.shape)) or real(mel))
    mell = _mel(13, B=2)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    ss.synth_batched(mell)
    groups = [k for k in ss.programs if k[0] == "batched"]
    assert len(calls) == len(groups) == 3
    assert sorted(calls) == sorted((2, span, 80) for _, span, _, _ in groups)  # one chunk a group, B = 2
    calls.clear()
    ss.synth(mell)
    assert len(calls) == len(ss._bounds(T))


def test_synth_scan_multi_utterance(models):
    """synth_scan with B > 1 equals the same utterances run one by one."""
    _, _, model = models
    mell = _mel(12, B=2, frames=80)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    y_all = ss.synth_scan(mell)
    assert y_all.shape == (2, 80 * HOP)
    for b in range(2):
        np.testing.assert_allclose(y_all[b: b + 1], ss.synth_scan(mell[b: b + 1]), rtol=1e-4, atol=2e-4)


def test_short_signal_is_one_shot(models):
    """A signal no longer than one chunk and its halo is one synthesis."""
    _, _, model = models
    mell = _mel(17, frames=40)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    y_one = _one_shot(model, mell)
    for mode in ("synth", "synth_batched", "synth_scan"):
        np.testing.assert_array_equal(getattr(ss, mode)(mell), y_one)
    assert not ss.programs


def test_chunked_matches_one_shot_with_rms_normalisation(models):
    """With normalize_rms_from_mell on, as in every registry model, the
    carries come from the F0 of the normalised mel, the contour the model
    synthesises with, so every mode still equals one-shot (2e-3; synth_scan
    away from the edges).  The JAX package takes the carry's F0 from the mel
    as given, and its chunked output departs from one-shot here (by more
    than 1e-2): the port departs from it on purpose."""
    _, params, _ = models
    hp = causal_small_hparams(force_causal=False)
    hp["mbexwn_config"]["normalize_rms_from_mell"] = True
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.block.load_state_dict(params_from_jax(flatten(jax_fold(params))), strict=True)
    assert model.norm_mel_components is not None
    mell = _mel(21)
    y_one = _one_shot(model, mell)
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    inner = slice(16 * HOP, (T - 16) * HOP)
    for mode in ("synth", "synth_batched", "synth_scan"):
        part = inner if mode == "synth_scan" else slice(None)
        assert rel_rms(getattr(ss, mode)(mell)[:, part], y_one[:, part]) < 2e-3, mode
    streamed = np.concatenate(list(ss.stream(mell[:, i: i + 8] for i in range(0, T, 8))), axis=1)
    assert rel_rms(streamed, y_one) < 2e-3
    j_chunked = JaxStreamingSynthesizer(jmodel, params, chunk_frames=32, halo_frames=16).synth(mell)
    assert rel_rms(j_chunked, y_one) > 1e-2  # the port's one-shot is JAX's within 1e-3 (test_torch_model.py)


def test_sigma0_registry_model_is_the_shipped_model_with_zero_noise():
    """The model the card checks use for chunked against one-shot: SPEECH's
    shipped weights in a model without the noise channel (block 0's start
    kernel without its noise column) equal the shipped model fed zero
    noise (full width, fp32, 16 frames)."""
    inv = MELInverter("SPEECH", device="cpu", length_buckets=(16,))
    model = create_registry_model("SPEECH", pp_mod_subnet_noise_channel_sigma=0)
    assert model.block.wn_in_channels == inv.model.block.wn_in_channels - 1
    mel = make_mel(3, 16)
    ref = inv.synth_from_mel(mel, noise=np.zeros(inv.noise_shape(mel), np.float32))
    with torch.inference_mode():
        got = model.infer(torch.from_numpy(mel), synth_length=16 * HOP).numpy().ravel()
    assert rel_rms(got, ref) <= 1e-6


def test_carry_follows_the_oscillator_phase():
    """The carry of 60 s of F0 at 12 kHz, summed chunk by chunk (chunks of
    512 frames), stays within 5e-5 cycles of the oscillator's one-shot
    phase at every chunk end: it sums the oscillator's own increments (F0
    times the fp32 reciprocal of the rate).  F0 / rate, the JAX package's
    carry, drifts beyond 1e-4 cycles by the end (the reciprocal's rounding,
    1.07e-8 of the phase)."""
    from mbexwn_vocoder_torch.ops.oscillator import phase_velocity, stable_cumsum_and_wrap
    from mbexwn_vocoder_torch.parallel.streaming import _phase_increment

    rate, n, chunk = 12000.0, 60 * 12000, 512 * 150
    rng = np.random.RandomState(0)
    f0 = torch.from_numpy((200 + 160 * np.abs(np.sin(np.cumsum(rng.randn(n)) * 1e-3))).astype(np.float32)[None])
    phase = stable_cumsum_and_wrap(phase_velocity(f0, rate))[0].double().numpy()
    carry = divided = 0.0
    err_carry, err_divided = [], []
    for t0 in range(0, n, chunk):
        t1 = min(n, t0 + chunk)
        carry = (carry + float(_phase_increment(f0[:, t0:t1], rate)[0])) % 1.0
        divided = (divided + float(f0[0, t0:t1].double().sum()) / rate) % 1.0
        for value, errs in ((carry, err_carry), (divided, err_divided)):
            d = (value - phase[t1 - 1]) % 1.0
            errs.append(min(d, 1.0 - d))
    assert max(err_carry) <= 5e-5
    assert err_divided[-1] > 1e-4


@pytest.mark.parametrize("T_inc", [1000, 2400, 4097])
def test_mod1_sum_matches_jax(T_inc):
    x = (np.random.RandomState(T_inc).rand(2, T_inc) * 0.05).astype(np.float32)
    got = _mod1_sum(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_mod1_sum(jnp.asarray(x)))
    d = np.abs(got - ref)
    assert np.max(np.minimum(d, 1.0 - d)) <= 1e-5


@pytest.fixture(scope="module")
def jax_streams(models):
    """Each streaming mode of the JAX package on one input (use_jit as its
    tests run it): {mode: audio}."""
    jmodel, params, _ = models
    mell = _mel(16, B=2)
    assert "MBEXWN_PALLAS_WN" not in os.environ
    js = JaxStreamingSynthesizer(jmodel, params, chunk_frames=32, halo_frames=16)
    out = {mode: getattr(js, mode)(mell) for mode in ("synth", "synth_batched", "synth_scan")}
    out["stream"] = np.concatenate(list(js.stream(mell[:, i: i + 8] for i in range(0, T, 8))), axis=1)
    return mell, out


@pytest.mark.parametrize("mode", ["synth", "synth_batched", "synth_scan", "stream"])
def test_streaming_matches_jax(models, jax_streams, mode):
    """Each mode against the JAX package's on two utterances at once."""
    _, _, model = models
    mell, ref = jax_streams
    ss = StreamingSynthesizer(model, chunk_frames=32, halo_frames=16, device="cpu")
    if mode == "stream":
        got = np.concatenate(list(ss.stream(mell[:, i: i + 8] for i in range(0, T, 8))), axis=1)
    else:
        got = getattr(ss, mode)(mell)
    assert got.shape == ref[mode].shape == (2, T * HOP)
    assert rel_rms(got, ref[mode]) <= 1e-3
