"""The port's training data pipeline against the JAX package's, on the CPU:
`upsample_f0`, `SegmentDataset` on the Python and on the native path (the
same seed, the same batches bit for bit), the native loader's build into
the port's `_build/` when the shared object is missing, and the prefetch
loader's shutdown and error path."""
import functools
import time

import numpy as np
import pytest

import mbexwn_vocoder_tpu.compat.native_loader as jax_native
from mbexwn_vocoder_tpu.compat.audio_io import write_wav as jax_write_wav
from mbexwn_vocoder_tpu.dsp.f0 import upsample_f0 as jax_upsample_f0
from mbexwn_vocoder_tpu.training.data import SegmentDataset as JaxSegmentDataset

import mbexwn_vocoder_torch.compat.native_loader as port_native
from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.dsp.f0 import upsample_f0
from mbexwn_vocoder_torch.training.data import PrefetchLoader, SegmentDataset
from mbexwn_vocoder_torch.training.synthetic import make_corpus


@pytest.fixture(scope="module")
def preprocess_config():
    pc = read_config(get_config_file("SPEECH"))["preprocess_config"]
    pc["segment_length"] = 6000
    return pc


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(str(d), n_utterances=3, seed=0, duration_range=(1.0, 1.6), quiet=True)
    return str(d)


@pytest.fixture(scope="module")
def mixed_rate_corpus(tmp_path_factory, corpus):
    """The corpus plus one utterance at 16 kHz: the native loader parses
    only files at the model's rate, so both packages take the Python path,
    which resamples it."""
    import shutil

    d = tmp_path_factory.mktemp("mixed")
    for name in ("synthetic_000_0000.wav", "synthetic_000_0001.wav"):
        shutil.copy(f"{corpus}/{name}", d / name)
    t = np.arange(20000) / 16000.0
    jax_write_wav(str(d / "low_rate.wav"), (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), 16000)
    return str(d)


@pytest.mark.parametrize("case", ["voiced edges", "all voiced", "all unvoiced", "short"])
def test_upsample_f0_matches_jax(case):
    rng = np.random.RandomState(3)
    f0 = (100 + 50 * rng.rand(41)).astype(np.float32)
    if case == "voiced edges":
        f0[5:9] = 0.0
        f0[30] = 0.0
    elif case == "all unvoiced":
        f0[:] = 0.0
    elif case == "short":
        f0 = f0[:2]
    total = 300 * (len(f0) - 1) + 123
    got, ref = upsample_f0(f0, 300, total), jax_upsample_f0(f0, 300, total)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


def _batches(ds, n=2, batch=5):
    return [ds.batch(batch) for _ in range(n)]


def _assert_batches_equal(got, ref):
    for g, r in zip(got, ref):
        assert g.keys() == r.keys() == {"audio", "mel", "F0"}
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape and np.array_equal(g[k], r[k]), k


def test_python_path_batches_are_bit_equal_to_jax(corpus, preprocess_config, capsys):
    port = SegmentDataset(corpus, preprocess_config, seed=7, use_native=False)
    jax = JaxSegmentDataset(corpus, preprocess_config, seed=7, use_native=False)
    assert port.source == "python" and "Python segment sampler" in capsys.readouterr().err
    got, ref = _batches(port), _batches(jax)
    _assert_batches_equal(got, ref)
    assert got[0]["audio"].shape == (5, 6000) and got[0]["mel"].shape == (5, 21, 80) and got[0]["F0"].shape == (5, 6000)
    assert (got[0]["F0"] > 0).any()


def test_sample_segment_is_bit_equal_to_jax(corpus, preprocess_config):
    """The public one-segment draw over the dataset's steps: the same
    (file, start) draws and features as the JAX package's, segment after
    segment."""
    port = SegmentDataset(corpus, preprocess_config, seed=5, use_native=False)
    jax = JaxSegmentDataset(corpus, preprocess_config, seed=5, use_native=False)
    for _ in range(3):
        got, ref = port.sample_segment(), jax.sample_segment()
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


def test_python_path_resamples_like_jax(mixed_rate_corpus, preprocess_config, capsys):
    port = SegmentDataset(mixed_rate_corpus, preprocess_config, seed=11)
    jax = JaxSegmentDataset(mixed_rate_corpus, preprocess_config, seed=11)
    assert port.source == "python" and jax._native is None
    assert "2 of 3 files parse natively" in capsys.readouterr().err
    _assert_batches_equal(_batches(port, n=3), _batches(jax, n=3))


def test_native_path_batches_are_bit_equal_to_jax(corpus, preprocess_config, monkeypatch, capsys):
    """One native worker on both sides: with two the order in which the
    workers' segments arrive is not fixed, in either package."""
    if not (port_native.available() and jax_native.available()):
        pytest.skip(f"no native segment loader: {port_native.load_error()}")
    for module in (port_native, jax_native):
        monkeypatch.setattr(module, "NativeSegmentLoader", functools.partial(module.NativeSegmentLoader, n_workers=1))
    port = SegmentDataset(corpus, preprocess_config, seed=5)
    jax = JaxSegmentDataset(corpus, preprocess_config, seed=5)
    try:
        assert port.source == "native" and jax._native is not None
        assert "native C++ segment loader over 3 files" in capsys.readouterr().err
        _assert_batches_equal(_batches(port), _batches(jax))
    finally:
        port.close()
        jax._native.close()


def test_native_library_is_built_into_the_port_build_dir(tmp_path, monkeypatch, corpus):
    """With the tracked shared object missing, the loader is compiled from
    native/segment_loader.cc into the build directory (never into
    native/), and it decodes the corpus as the Python reader does."""
    from mbexwn_vocoder_torch.compat.audio_io import read_wav

    build = tmp_path / "_build"
    monkeypatch.setattr(port_native, "SO_PATH", tmp_path / "missing" / "libsegment_loader.so")
    monkeypatch.setattr(port_native, "BUILD_DIR", build)
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_error", None)
    before = sorted(p.name for p in port_native.NATIVE_DIR.iterdir())
    assert port_native.available(), port_native.load_error()
    assert sorted(p.name for p in build.iterdir()) == ["libsegment_loader.so"]
    assert sorted(p.name for p in port_native.NATIVE_DIR.iterdir()) == before
    path = f"{corpus}/synthetic_000_0000.wav"
    ref, _ = read_wav(path)
    loader = port_native.NativeSegmentLoader([path], segment_len=ref.shape[0], sample_rate=24000, n_workers=1)
    try:
        assert loader.n_files == 1 and np.array_equal(loader.next_batch(1)[0], ref)
    finally:
        loader.close()


def test_native_library_build_failure_is_reported(tmp_path, monkeypatch, corpus, preprocess_config, capsys):
    """No shared object and no compiler: the dataset takes the Python path
    and says why."""
    monkeypatch.setattr(port_native, "SO_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_error", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not port_native.available() and "missing.so is missing" in port_native.load_error()
    ds = SegmentDataset(corpus, preprocess_config, seed=0)
    assert ds.source == "python" and "building it from" in capsys.readouterr().err


def test_prefetch_loader_closes_in_time(corpus, preprocess_config):
    ds = SegmentDataset(corpus, preprocess_config, seed=1, use_native=False)
    loader = PrefetchLoader(ds, 4, num_workers=2, depth=2)
    batches = iter(loader)
    first = next(batches)
    assert first["audio"].shape == (4, 6000)
    time.sleep(0.5)  # the queue fills and both workers block on it
    t0 = time.monotonic()
    assert loader.close(timeout=10.0)
    assert time.monotonic() - t0 < 10.0 and not any(w.is_alive() for w in loader.workers)
    stats = loader.stats()
    assert stats["batches_made"] >= 1 and stats["ms_per_batch_per_worker_median"] > 0


def test_prefetch_loader_raises_a_worker_error():
    class Broken:
        def batch(self, n):
            raise ValueError("unreadable file")

    loader = PrefetchLoader(Broken(), 2, num_workers=1)
    with pytest.raises(ValueError, match="unreadable file"):
        next(iter(loader))
    assert loader.close(timeout=5.0)
