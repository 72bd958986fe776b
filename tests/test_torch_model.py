"""The port's mel-inversion slice against the JAX package at full width:
SPEECH (C=320) and VOICE (C=340) with their shipped weights, a 64-frame
mel made from a seed (an exact-length bucket, so no edge padding), fp32.

The noise channel is drawn once with the JAX package's own draw,
jax.random.normal(PRNGKey(0), (B, T_wn, 1)), and injected into the port.
Per-stage budgets are those the JAX package holds itself to against the TF
reference (COMPONENTS.md): F0 1e-6, excitation 3e-4, envelope 1e-5 and the
whole MELInverter.synth_from_mel 1e-3, all rel-RMS.  Each stage is fed the
same (JAX-normalised) mel and F0, so its error is its own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mbexwn_vocoder_tpu.mel_inverter import MELInverter as JaxMELInverter

from mbexwn_vocoder_torch.mel_inverter import MELInverter

torch.set_num_threads(2)
T_MEL = 64


def rel_rms(got, ref):
    got = np.asarray(got, np.complex128 if np.iscomplexobj(got) else np.float64)
    ref = np.asarray(ref, got.dtype)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def make_mel(seed, n_frames=T_MEL, n_mels=80):
    """A log-mel with a spectral tilt, moving formant-like bumps and noise."""
    rng = np.random.RandomState(seed)
    band = np.arange(n_mels)[None, :]
    t = np.arange(n_frames)[:, None]
    formants = sum(1.5 * np.exp(-0.5 * ((band - (c + 4 * np.sin(2 * np.pi * t / p))) / w) ** 2)
                   for c, p, w in ((8, 37, 3.0), (22, 23, 4.0), (40, 51, 6.0)))
    mel = -2.0 - 0.06 * band + formants + np.sin(2 * np.pi * t / 41.0) + 0.3 * rng.randn(n_frames, n_mels)
    return mel[None].astype(np.float32)


def jax_noise(shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape, dtype=jnp.float32))


@pytest.mark.parametrize("model_id", ["SPEECH", "VOICE"])
def test_full_width_slice_matches_jax(model_id):
    mel = make_mel(7)
    port = MELInverter(model_id, device="cpu", length_buckets=(T_MEL,))
    ref = JaxMELInverter(model_id, length_buckets=(T_MEL,), use_jit=False)
    assert port.model.block.wn_compute_dtype is None  # conftest pins fp32
    hop = port.hop_size
    noise = jax_noise(port.noise_shape(mel))

    # mel RMS normalisation
    _, j_mell, j_rms = ref.model.norm_mel_components.normalize_inputs_by_rms(None, jnp.asarray(mel), T_MEL * hop)
    _, t_mell, t_rms = port.model.norm_mel_components.normalize_inputs_by_rms(None, torch.from_numpy(mel), T_MEL * hop)
    assert rel_rms(t_mell, j_mell) <= 1e-6 and rel_rms(t_rms, j_rms) <= 1e-6

    mell = np.asarray(j_mell)
    x = torch.from_numpy(mell.copy())
    blk, jblk, params = port.model.block, ref.model.block, ref.params
    with torch.no_grad():
        f0_ref = np.asarray(jblk.generate_f0(params, jnp.asarray(mell)))
        f0 = blk.generate_f0(x)
        assert f0.shape == f0_ref.shape and rel_rms(f0, f0_ref) <= 1e-6

        f0_in = torch.from_numpy(f0_ref.copy())
        exc_ref = jblk.generate_excitation(params, jnp.asarray(mell), jnp.asarray(f0_ref), noise=jnp.asarray(noise))
        exc = blk.generate_excitation(x, f0_in, noise=torch.from_numpy(noise.copy()))
        assert exc.shape == exc_ref.shape and rel_rms(exc, exc_ref) <= 3e-4

        env_ref = jblk.generate_specenv(params, jnp.asarray(mell), jnp.asarray(f0_ref))
        env = blk.generate_specenv(x, f0_in)
        assert env.shape == env_ref.shape and rel_rms(env.numpy(), env_ref) <= 1e-5

    y = port.synth_from_mel(mel, noise=noise)
    y_ref = ref.synth_from_mel(mel)
    assert y.shape == y_ref.shape == (T_MEL * hop,)
    assert rel_rms(y, y_ref) <= 1e-3


def test_infer_components_and_return_F0_match_jax():
    """`infer_components` and `infer(return_F0=True)` of SPEECH against the
    JAX package's, the noise the JAX package draws (PRNGKey(0)) injected:
    F0 1e-6, excitation 3e-4, envelope 1e-5 and RMS 1e-6 (the stage
    budgets above), the sound 1e-3; `transposition_factor` scales the F0."""
    mel = make_mel(9)
    port = MELInverter("SPEECH", device="cpu", length_buckets=(T_MEL,))
    ref = JaxMELInverter("SPEECH", length_buckets=(T_MEL,), use_jit=False)
    model, jmodel, params = port.model, ref.model, ref.params
    assert model.has_components and jmodel.has_components
    hop = port.hop_size
    noise = torch.from_numpy(jax_noise(port.noise_shape(mel)).copy())
    x = torch.from_numpy(mel)
    with torch.no_grad():
        got = model.infer_components(x, noise=noise)
        scaled_f0 = model.infer_components(x, transposition_factor=1.5, noise=noise)[0]
        y, pp = model.infer(x, synth_length=T_MEL * hop, noise=noise, return_F0=True)
    want = jmodel.infer_components(params, jnp.asarray(mel))
    for name, g, w, tol in zip(("F0", "excitation", "envelope", "rms"), got, want, (1e-6, 3e-4, 1e-5, 1e-6)):
        assert g.shape == w.shape and rel_rms(g.numpy(), np.asarray(w)) <= tol, name
    assert torch.equal(scaled_f0, 1.5 * got[0])
    y_ref, pp_ref = jmodel.infer(params, jnp.asarray(mel), synth_length=T_MEL * hop, return_F0=True)
    assert rel_rms(y, y_ref) <= 1e-3
    assert [n for n, _ in pp] == [n for n, _ in pp_ref] == ["F0", "PSig", "PS"]
    for (name, g), (_, w), tol in zip(pp, pp_ref, (1e-6, 3e-4, 1e-5)):
        assert g.shape == w.shape and rel_rms(g.numpy(), np.asarray(w)) <= tol, name
    with torch.no_grad():
        listed = model.infer(x, synth_length=T_MEL * hop, noise=noise, return_components=True)
    assert isinstance(listed, list) and torch.equal(listed[0], y)


def test_shipped_bf16_mode_tracks_jax(monkeypatch):
    """The registry's bf16 compute (WaveNet and subnets) in both packages:
    bf16 rounds at other points in the two frameworks (cuDNN/oneDNN vs XLA
    accumulation order, the K1 plain version's fp32 skip sum), so the bound
    is 5e-2 rel-RMS, where fp32 agrees to 1e-3 and bf16 against fp32 in
    either package differs by ~0.6 (phase drift of the bf16 F0)."""
    monkeypatch.delenv("MBEXWN_WN_DTYPE", raising=False)
    monkeypatch.delenv("MBEXWN_SUBNET_DTYPE", raising=False)
    mel = make_mel(8)
    port = MELInverter("SPEECH", device="cpu", length_buckets=(T_MEL,))
    ref = JaxMELInverter("SPEECH", length_buckets=(T_MEL,), use_jit=False)
    assert port.model.block.wn_compute_dtype == torch.bfloat16
    assert port.model.block.subnet_compute_dtype == torch.bfloat16
    y = port.synth_from_mel(mel, noise=jax_noise(port.noise_shape(mel)))
    y_ref = ref.synth_from_mel(mel)
    assert np.isfinite(y).all() and y.shape == y_ref.shape
    assert rel_rms(y, y_ref) <= 5e-2


def test_length_buckets_pad_and_trim():
    """A 50-frame mel runs in the 64-frame bucket (edge-padded) and comes
    back trimmed to 50 frames; its noise follows the padded length."""
    port = MELInverter("SPEECH", device="cpu", length_buckets=(T_MEL, 128))
    mel = make_mel(9)[:, :50]
    assert port.noise_shape(mel) == (1, T_MEL * 25, 1)
    y = port.synth_from_mel(mel)
    assert y.shape == (50 * port.hop_size,) and np.isfinite(y).all()
    # the same call draws the same noise (a generator seeded 0 per call)
    np.testing.assert_array_equal(port.synth_from_mel(mel), y)



@pytest.mark.parametrize("hoplen,nfft", [(300, 2048), (256, 1024)])
def test_scale_mel_matches_jax(hoplen, nfft):
    """An external `.mell` dict rescaled into the model's convention: log
    offsets and scales, the fft-size factor, and (hop 256) the hop-size
    interpolation."""
    rng = np.random.RandomState(hoplen)
    mel_config = {"mell": rng.randn(80, 40).astype(np.float32) - 5.0, "fmin": 0.0, "fmax": 12000.0, "sr": 24000,
                  "hoplen": hoplen, "nfft": nfft, "log_spec_offset": 0.5, "log_spec_scale": 2.0,
                  "lin_spec_offset": 1e-6, "lin_spec_scale": 1.0}
    port = MELInverter("SPEECH", device="cpu")
    ref = JaxMELInverter("SPEECH", use_jit=False)
    got = port.scale_mel(mel_config)
    np.testing.assert_array_equal(got, ref.scale_mel(mel_config))
    with pytest.raises(RuntimeError, match="fmin"):
        port.scale_mel({**mel_config, "fmin": 50.0})


def test_warm_runs_each_bucket():
    port = MELInverter("SPEECH", device="cpu", length_buckets=(16, 32))
    port.warm()
    port.warm(buckets=(16,), batch_size=2)
