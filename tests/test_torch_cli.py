"""The port's analysis front end, corpus generator, file formats, CLIs and
quality metrics on the CPU.

The analysis (STFT, mel filterbank, resampler, YIN F0, the log-mel of
`compute_mel_spectrogram_internal` and `generate_mel_from_snd`) and the
synthetic eval corpus are NumPy copies of the JAX package's, so they are
held to it bit for bit.  The CLIs run end to end with MBEXWN_PLATFORM=cpu
through the real file formats (wav and the `.mell` pickle), at full width
with the registry's SPEECH weights.
"""
import os
import sys

import numpy as np
import pytest
import torch

from mbexwn_vocoder_tpu import analysis as jax_analysis
from mbexwn_vocoder_tpu.compat import audio_io as jax_audio_io
from mbexwn_vocoder_tpu.compat import iovar as jax_iovar
from mbexwn_vocoder_tpu.dsp import f0 as jax_f0
from mbexwn_vocoder_tpu.dsp import mel as jax_mel
from mbexwn_vocoder_tpu.dsp import resample as jax_resample
from mbexwn_vocoder_tpu.dsp import stft as jax_stft
from mbexwn_vocoder_tpu.mel_inverter import MELInverter as JaxMELInverter
from mbexwn_vocoder_tpu.training import synthetic as jax_synthetic

from mbexwn_vocoder_torch import analysis, get_config_file, quality
from mbexwn_vocoder_torch.cli import generate_mel, resynth_mel, view_mel
from mbexwn_vocoder_torch.compat import audio_io, iovar
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.dsp import f0, mel, resample, stft
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.training import synthetic

torch.set_num_threads(2)
SR = 24000


def _tone(n=12000, freq=220.0):
    t = np.arange(n) / SR
    return (0.5 * np.sin(2 * np.pi * freq * t) * (0.5 - 0.5 * np.cos(2 * np.pi * t / t[-1]))).astype(np.float32)


@pytest.fixture(scope="module")
def utterance():
    """The first utterance of SPEECH's held-out corpus (seed 1099)."""
    rng = np.random.RandomState(1099)
    return synthetic.synth_utterance(rng, duration_s=rng.uniform(2.0, 4.0), sr=SR, style="speech")[0]


@pytest.fixture(scope="module")
def preprocess_config():
    return read_config(get_config_file("SPEECH"))["preprocess_config"]


@pytest.fixture(scope="module")
def tone_wavs(tmp_path_factory):
    """0.5 s (41 frames, bucket 64) and 1.0 s (81 frames, bucket 128) tones."""
    d = tmp_path_factory.mktemp("audio")
    paths = []
    for name, n, freq in (("tone", 12000, 220.0), ("long", 24000, 330.0)):
        paths.append(str(d / f"{name}.wav"))
        audio_io.write_wav(paths[-1], _tone(n, freq), SR)
    return paths


@pytest.mark.parametrize("signal", ["tone", "utterance"])
def test_analysis_matches_jax(signal, utterance, preprocess_config):
    x = _tone(SR, 440.0) if signal == "tone" else utterance
    pc = preprocess_config
    for kw in (dict(do_mag=True), dict(do_mag=False, detrend_phase=True), dict(center=False, do_mag=True)):
        args = (x[None], pc["win_size"], pc["hop_size"], pc["fft_size"])
        np.testing.assert_array_equal(stft.calc_stft(*args, **kw), jax_stft.calc_stft(*args, **kw))
    spec = jax_stft.calc_stft(x[None], pc["win_size"], pc["hop_size"], pc["fft_size"])
    np.testing.assert_array_equal(stft.calc_istft(spec, pc["win_size"], pc["hop_size"], pc["fft_size"], x.size),
                                  jax_stft.calc_istft(spec, pc["win_size"], pc["hop_size"], pc["fft_size"], x.size))
    for kw in (dict(), dict(centered=True), dict(norm=False)):
        np.testing.assert_array_equal(mel.mel_filter(SR, 2048, 80, 0.0, 12000.0, **kw),
                                      jax_mel.mel_filter(SR, 2048, 80, 0.0, 12000.0, **kw))
    for sr_in, sr_out in ((SR, 16000), (22050, SR)):
        got, filt = resample.resample(x, sr_in, sr_out)
        ref, ref_filt = jax_resample.resample(x, sr_in, sr_out)
        np.testing.assert_array_equal(filt, ref_filt)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(f0.estimate_f0(x, SR, 300, fmin=40.0, fmax=600.0),
                                  jax_f0.estimate_f0(x, SR, 300, fmin=40.0, fmax=600.0))
    for kw in (dict(do_post=False), dict(do_post=True), dict(band_limit=(50.0, 8000.0, 10000.0))):
        got = analysis.compute_mel_spectrogram_internal(x, pc, **kw)
        ref = jax_analysis.compute_mel_spectrogram_internal(x, pc, **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    if signal == "tone":  # a 440 Hz tone peaks in the mel band whose centre is nearest 440 Hz
        mell = analysis.compute_mel_spectrogram_internal(x, pc, do_post=False)[0][0]
        centres = mel.mel_frequencies(82, 0.0, 12000.0)[1:-1]
        assert np.argmax(mell[20]) == np.argmin(np.abs(centres - 440.0))


def test_mel_helpers_match_jax(preprocess_config):
    rng = np.random.RandomState(0)
    lin = np.exp(rng.randn(1, 20, 80)).astype(np.float32)
    for forward, x in ((True, lin), (False, np.log(lin + 1e-5))):
        np.testing.assert_array_equal(analysis.scale_mel_spectrogram(x, preprocess_config, forward=forward),
                                      jax_analysis.scale_mel_spectrogram(x, preprocess_config, forward=forward))
    for kw in (dict(), dict(mell_is_log=False), dict(num_smooth_iters=0)):
        x = lin if kw.get("mell_is_log") is False else np.log(lin)
        np.testing.assert_array_equal(analysis.norm_mell(x, preprocess_config, **kw),
                                      jax_analysis.norm_mell(x, preprocess_config, **kw))
    for g, r in zip(analysis.get_mel_lin_interpol_params(preprocess_config, 4096),
                    jax_analysis.get_mel_lin_interpol_params(preprocess_config, 4096)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed,style", [(1099, "speech"), (1098, "singing"), (1097, "mixed")])
def test_corpus_matches_jax(seed, style, tmp_path):
    """The first two utterances of each v2 eval corpus, as wav files, are
    bit-equal to the JAX package's, and so are synth_utterance's contours."""
    got = synthetic.make_corpus(str(tmp_path / "port"), n_utterances=2, seed=seed, style=style, quiet=True)
    ref = jax_synthetic.make_corpus(str(tmp_path / "jax"), n_utterances=2, seed=seed, style=style, quiet=True)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    for p, r in zip(got, ref):
        with open(p, "rb") as a, open(r, "rb") as b:
            assert a.read() == b.read()
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    for g, r in zip(synthetic.synth_utterance(rng, 1.0, style="singing", shifted=True),
                    jax_synthetic.synth_utterance(jrng, 1.0, style="singing", shifted=True)):
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def inverters():
    return MELInverter("SPEECH", device="cpu"), JaxMELInverter("SPEECH", use_jit=False)


@pytest.mark.parametrize("srate", [SR, 16000])
def test_generate_mel_from_snd_matches_jax(inverters, utterance, srate):
    port, ref = inverters
    snd = utterance if srate == SR else resample.resample(utterance, SR, srate)[0]
    got, want = port.generate_mel_from_snd(snd, srate), ref.generate_mel_from_snd(snd, srate)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(port.scale_mel(got), ref.scale_mel(want))


def test_mell_and_wav_interchange(tone_wavs, tmp_path):
    """A `.mell` the JAX generate_mel wrote loads in the port and equals the
    port's own analysis; the port's `.mell` and wav load in the JAX package."""
    from mbexwn_vocoder_tpu.cli.generate_mel import main as jax_generate

    jax_generate(tone_wavs[:1], str(tmp_path / "jax"), model_id="SPEECH")
    generate_mel.main(tone_wavs[:1], str(tmp_path / "port"), model_id="SPEECH")
    from_jax = iovar.load_var(str(tmp_path / "jax" / "tone.mell"))
    from_port = jax_iovar.load_var(str(tmp_path / "port" / "tone.mell"))
    assert from_jax.keys() == from_port.keys()
    for k in from_jax:
        np.testing.assert_array_equal(from_jax[k], from_port[k])
    assert from_port["mell"].shape == (80, 41) and from_port["hoplen"] == 300

    gz = str(tmp_path / "x.mell.gz")
    iovar.save_var(gz, from_port)
    np.testing.assert_array_equal(jax_iovar.load_var(gz)["mell"], from_port["mell"])
    x = _tone(1000)
    for subtype in ("float32", "pcm16"):
        path = str(tmp_path / f"x_{subtype}.wav")
        audio_io.write_wav(path, x, SR, subtype=subtype)
        got, want = jax_audio_io.read_wav(path), audio_io.read_wav(path)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == SR
    jax_audio_io.write_wav(path, x, SR)
    np.testing.assert_array_equal(audio_io.read_wav(path)[0], x)


def test_cli_round_trip(tone_wavs, tmp_path, monkeypatch, capsys):
    """generate_mel -> resynth_mel on the CPU (MBEXWN_PLATFORM=cpu): the
    blocking loop with the `-v` report, and --pipeline 2 --batch 4 with the
    same wavs out.  The two files lie in different buckets, so each
    dispatch group holds one file and draws the blocking loop's noise."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    meldir = str(tmp_path / "mel")
    generate_mel.main(tone_wavs, meldir, model_id="SPEECH")
    mells = [os.path.join(meldir, n) for n in ("tone.mell", "long.mell")]
    resynth_mel.main("SPEECH", mells, str(tmp_path / "blocking"), verbose=True)
    assert capsys.readouterr().err.count("mel_error:") == 2
    resynth_mel.main("SPEECH", mells, str(tmp_path / "pipelined"), pipeline=2, batch=4, verbose=True)
    err = capsys.readouterr().err
    assert err.count("mel_error:") == 2 and "pipelined 2 files" in err
    for name, frames in (("syn_tone.wav", 41), ("syn_long.wav", 81)):
        y0, sr0 = audio_io.read_wav(str(tmp_path / "blocking" / name))
        y1, sr1 = audio_io.read_wav(str(tmp_path / "pipelined" / name))
        assert sr0 == sr1 == SR and y0.shape == (frames * 300,) and np.isfinite(y0).all()
        np.testing.assert_array_equal(y0, y1)


def test_resynth_needs_the_card_unless_told(tone_wavs, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is about hosts without one")
    monkeypatch.delenv("MBEXWN_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resynth_mel.main("SPEECH", [], str(tmp_path))
    monkeypatch.setenv("MBEXWN_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MBEXWN_PLATFORM"):
        resynth_mel.main("SPEECH", [], str(tmp_path))


def test_resynth_precision_knob(monkeypatch):
    """--precision maps onto the compute-dtype env knobs (quality = fp32 via
    an EMPTY value, fast = bf16), without clobbering an explicit export."""
    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    resynth_mel.apply_precision("default")
    assert "MBEXWN_WN_DTYPE" not in os.environ
    resynth_mel.apply_precision("quality")
    assert os.environ["MBEXWN_WN_DTYPE"] == "" and os.environ["MBEXWN_SUBNET_DTYPE"] == ""
    assert MELInverter("SPEECH", device="cpu").model.block.wn_compute_dtype is None
    monkeypatch.setenv("MBEXWN_WN_DTYPE", "float32")
    monkeypatch.setenv("MBEXWN_SUBNET_DTYPE", "float32")
    resynth_mel.apply_precision("fast")
    assert os.environ["MBEXWN_WN_DTYPE"] == "float32"
    monkeypatch.delenv("MBEXWN_WN_DTYPE")
    monkeypatch.delenv("MBEXWN_SUBNET_DTYPE")
    resynth_mel.apply_precision("fast")
    assert os.environ["MBEXWN_WN_DTYPE"] == os.environ["MBEXWN_SUBNET_DTYPE"] == "bfloat16"
    assert MELInverter("SPEECH", device="cpu").model.block.wn_compute_dtype == torch.bfloat16


def test_resynth_lists_models_without_a_model_id(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["resynth_mel"])
    resynth_mel.cli()
    out = capsys.readouterr().out
    assert "Please select one of the following models" in out
    for m in ("SPEECH/MBExWN_TPU_SPEECH_WNCHA320_24kHz", "SING/MBExWN_TPU_SING_WNCHA320_24kHz",
              "VOICE/MBExWN_TPU_VOICE_WNCHA340_24kHz"):
        assert f" - {m}" in out


def test_view_mel_cli(tone_wavs, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    png = str(tmp_path / "mel.png")
    mell_dir = str(tmp_path / "mel")
    generate_mel.main(tone_wavs[:1], mell_dir, model_id="SPEECH")
    view_mel.main([tone_wavs[0], os.path.join(mell_dir, "tone.mell")], model_id="SPEECH", output=png,
                  diff_mel=True, cargs=["preprocess_config:fmin=0.0"])
    assert os.path.getsize(png) > 0
    out = capsys.readouterr()
    # the wav's analysis and the .mell of the same wav agree exactly
    assert "mel-L1 diff" in out.out and ": 0.000 dB" in out.out
    assert "frames=41 bands=80" in out.err


def test_quality_metrics_by_hand():
    rng = np.random.RandomState(0)
    a = rng.randn(30, 80)
    assert quality.mel_l1_db(a, a + 0.5) == pytest.approx(0.5 * 20 / np.log(10))
    assert quality.mcd_db(a, a) == 0.0
    assert quality.mcd_db(a, a + 3.0) == pytest.approx(0.0, abs=1e-12)  # a level shift is c0 only
    n, k, amp = 80, 5, 0.2
    basis = np.sqrt(2.0 / n) * np.cos(np.pi * k * (2 * np.arange(n) + 1) / (2 * n))  # DCT-II (ortho) row k
    assert quality.mcd_db(a, a + amp * basis) == pytest.approx(10 * np.sqrt(2) / np.log(10) * amp)
    assert quality.mcd_db(a, a + amp * np.sqrt(2.0 / n) * np.cos(np.pi * 30 * (2 * np.arange(n) + 1) / (2 * n))) \
        == pytest.approx(0.0, abs=1e-12)  # cepstrum 30 lies outside 1..24
    rmse, verr = quality.f0_errors(np.array([100.0, 0.0, 200.0, 150.0, 0.0]), np.array([110.0, 120.0, 0.0, 150.0]))
    assert rmse == pytest.approx(np.sqrt(50.0)) and verr == pytest.approx(50.0)
    assert np.isnan(quality.f0_errors(np.zeros(3), np.zeros(3))[0])
    tone = _tone(SR, 200.0).astype(np.float64)
    rmse, verr = quality.f0_metrics(tone, tone, SR, 40.0, 600.0)
    assert rmse == 0.0 and verr == 0.0
    rows = [{"mel_L1_dB": 1.0, "mcd_dB": 2.0, "f0_rmse_hz": None, "voicing_err_pct": 4.0},
            {"mel_L1_dB": 2.0, "mcd_dB": 4.0, "f0_rmse_hz": 3.0, "voicing_err_pct": 0.0}]
    assert quality.summarize(rows) == {"n_files": 2, "mean_mel_L1_dB": 1.5, "mean_mcd_dB": 3.0,
                                       "mean_f0_rmse_hz": 3.0, "mean_voicing_err_pct": 2.0}


@pytest.mark.parametrize("expr", ["preprocess_config:fmin=10.0", "preprocess_config:fmax:11000",
                                  "mbexwn_config:pp_subnet:[0]:[1]=96",
                                  "mbexwn_config:pp_mod_subnet:n_layers=4:n_channels=64"])
def test_config_overrides_match_jax(expr):
    """view_mel's `-a` overrides: the port's copy of the override language
    edits a registry config as the JAX package's does."""
    from mbexwn_vocoder_tpu.config import config_utils as jax_cutils

    from mbexwn_vocoder_torch.config import modify_config

    got = modify_config(read_config(get_config_file("SPEECH")), [expr])
    ref = jax_cutils.modify_config(read_config(get_config_file("SPEECH")), [expr])
    assert got == ref != read_config(get_config_file("SPEECH"))
