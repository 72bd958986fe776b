"""The port's serving path on the CPU: PipelinedSynthesizer and
BatchSynthesizer against the JAX package's, and the pipeline's own contract
(ported from tests/test_serving.py).

The model is SPEECH's config at narrow WaveNet width (16 channels, 2
layers) with the noise channel off, so a batch of several utterances is
deterministic and comparable across frameworks; JAX's random init, folded,
is loaded into the port.  fp32 (conftest).  Port vs JAX: 1e-3 rel-RMS, the
whole-synthesis budget of the mel-inversion slice.  Within the port,
pipelined serving equals the blocking path bit for bit.
"""
import numpy as np
import pytest
import torch

import jax

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold
from mbexwn_vocoder_tpu.parallel.batch import BatchSynthesizer as JaxBatchSynthesizer
from mbexwn_vocoder_tpu.serving import PipelinedSynthesizer as JaxPipelinedSynthesizer

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, params_from_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.mel_inverter import edge_pad
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.parallel.batch import BatchSynthesizer
from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

from tests.test_torch_model import rel_rms

torch.set_num_threads(2)
BUCKETS = (8, 16)


@pytest.fixture(scope="module")
def small_models():
    hp = read_config(get_config_file("SPEECH"))
    mc = hp["mbexwn_config"]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=2, n_out_channels=8)
    mc["pp_mod_subnet_noise_channel_sigma"] = 0
    mc["normalize_rms_from_mell"] = False
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jmodel.init(jax.random.PRNGKey(0), batch_size=1, T_mel=8)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.block.load_state_dict(params_from_jax(flatten(jax_fold(params))), strict=True)
    return jmodel, params, model.eval()


def _mels(n, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(T, 80).astype(np.float32) * 0.5 - 4.0 for T in lengths[:n]]


def _blocking(model, mel, T_pad):
    """MELInverter.synth_from_mel's arithmetic for one (T, C) mel."""
    x = torch.from_numpy(edge_pad(mel[None], T_pad))
    with torch.inference_mode():
        y = model.infer(x, synth_length=T_pad * model.spect_hop_size)
    return y[0, : mel.shape[0] * model.spect_hop_size].numpy()


@pytest.mark.parametrize("batch", [1, 8])
def test_pipeline_matches_jax(small_models, batch):
    """Mixed lengths across both buckets, in submission order, against the
    JAX pipeline with the same depth and batch (1e-3 rel-RMS per utterance)."""
    jmodel, params, model = small_models
    lengths = [5, 12, 8, 3, 16, 8, 7, 16, 9, 8, 8, 6]
    mels = _mels(len(lengths), lengths, seed=6)
    got = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=3, batch=batch, device="cpu").map(mels)
    ref = JaxPipelinedSynthesizer(jmodel, params, length_buckets=BUCKETS, depth=3, batch=batch).map(mels)
    assert [y.shape for y in got] == [y.shape for y in ref] == [(T * 300,) for T in lengths]
    for y, r in zip(got, ref):
        assert rel_rms(y, r) <= 1e-3


def test_pipeline_matches_blocking_path(small_models):
    _, _, model = small_models
    mels = _mels(4, [8, 8, 8, 8])
    got = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=2, batch=1, device="cpu").map(mels)
    for m, y in zip(mels, got):
        assert y.shape == (m.shape[0] * model.spect_hop_size,)
        np.testing.assert_array_equal(y, _blocking(model, m, 8))


def test_pipeline_mixed_lengths_and_order(small_models):
    """Mixed bucket sizes arrive back in submission order with padded tails
    trimmed to each utterance's true length, each equal to its own blocking
    synthesis."""
    _, _, model = small_models
    hop = model.spect_hop_size
    lengths = [5, 12, 8, 3, 16]
    mels = _mels(5, lengths, seed=1)
    ps = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=3, batch=1, device="cpu")
    got = ps.map(mels)
    assert [y.shape[0] for y in got] == [T * hop for T in lengths]
    for m, y in zip(mels, got):
        np.testing.assert_array_equal(y, _blocking(model, m, ps._bucket_len(m.shape[0])))


def test_stream_is_incremental(small_models):
    """stream() yields result i after only ~depth dispatches, not after all
    inputs are consumed (the property that bounds serving latency)."""
    _, _, model = small_models
    consumed = []

    def feed():
        for i, m in enumerate(_mels(4, [8] * 4, seed=2)):
            consumed.append(i)
            yield m

    it = PipelinedSynthesizer(model, length_buckets=(8,), depth=2, batch=1, device="cpu").stream(feed())
    next(it)
    assert len(consumed) == 2  # depth in flight, not the whole input list
    assert len(list(it)) == 3


def test_micro_batching_matches_per_utterance(small_models):
    """batch > 1 stacks same-bucket utterances into one device batch; results
    come back in submission order, equal (within batched-conv float
    reassociation) to one request per dispatch, across bucket changes and a
    partial trailing group."""
    _, _, model = small_models
    hop = model.spect_hop_size
    lengths = [8, 7, 8, 12, 16, 5, 8]  # buckets: 8,8,8,16,16,8,8
    mels = _mels(7, lengths, seed=3)
    got = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=2, batch=3, device="cpu").map(mels)
    assert [y.shape[0] for y in got] == [T * hop for T in lengths]
    single = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=1, batch=1, device="cpu").map(mels)
    for y, y1 in zip(got, single):
        scale = max(np.abs(y1).max(), 1e-6)
        np.testing.assert_allclose(y / scale, y1 / scale, rtol=0, atol=3e-5)


def test_default_coalescing(small_models):
    """Coalescing is the default: 8 concurrent same-bucket requests make one
    dispatch group, while a single request still dispatches alone and
    equals the blocking path."""
    _, _, model = small_models
    hop = model.spect_hop_size
    ps = PipelinedSynthesizer(model, length_buckets=BUCKETS, device="cpu")
    assert ps.batch == 8 and ps.depth >= 2

    (m,) = _mels(1, [8], seed=4)
    np.testing.assert_array_equal(ps.map([m])[0], _blocking(model, m, 8))

    dispatched = []
    orig = ps._dispatch_group

    def spy(group, T_pad):
        dispatched.append(len(group))
        return orig(group, T_pad)

    ps._dispatch_group = spy
    got = ps.map(_mels(8, [8] * 8, seed=5))
    assert dispatched == [8]
    assert [y.shape[0] for y in got] == [8 * hop] * 8


def test_warm_covers_buckets(small_models):
    _, _, model = small_models
    ps = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=2, device="cpu")
    shapes = []
    orig = ps._synthesize

    def spy(mell):
        shapes.append(tuple(mell.shape))
        return orig(mell)

    ps._synthesize = spy
    ps.warm()
    assert shapes == [(1, 8, 80), (1, 16, 80)]


def test_depth_and_batch_validation(small_models):
    _, _, model = small_models
    with pytest.raises(ValueError, match="depth"):
        PipelinedSynthesizer(model, depth=0, device="cpu")
    with pytest.raises(ValueError, match="micro-batch"):
        PipelinedSynthesizer(model, batch=0, device="cpu")
    with pytest.raises(ValueError, match="one utterance"):
        PipelinedSynthesizer(model, device="cpu").map([np.zeros((2, 8, 80), np.float32)])


def test_batch_synthesizer_matches_jax(small_models):
    """Five mixed lengths over both buckets, results in input order (1e-3)."""
    jmodel, params, model = small_models
    lengths = [12, 5, 16, 8, 3]
    mels = _mels(5, lengths, seed=7)
    got = BatchSynthesizer(model, length_buckets=BUCKETS, device="cpu").synth_batch(mels)
    ref = JaxBatchSynthesizer(jmodel, params, length_buckets=BUCKETS).synth_batch(mels)
    assert [y.shape for y in got] == [y.shape for y in ref] == [(T * 300,) for T in lengths]
    for y, r in zip(got, ref):
        assert rel_rms(y, r) <= 1e-3


def test_batch_synthesizer_over_a_mesh_matches_jax(small_models):
    """The five mixed lengths over a mesh of two CPU devices: each row as
    without a mesh (1e-6) and as the JAX package's (1e-3)."""
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh

    jmodel, params, model = small_models
    mels = _mels(5, [12, 5, 16, 8, 3], seed=7)
    got = BatchSynthesizer(model, mesh=make_mesh(devices=["cpu", "cpu"]), length_buckets=BUCKETS).synth_batch(mels)
    single = BatchSynthesizer(model, length_buckets=BUCKETS, device="cpu").synth_batch(mels)
    ref = JaxBatchSynthesizer(jmodel, params, length_buckets=BUCKETS).synth_batch(mels)
    for y, s, r in zip(got, single, ref):
        assert y.shape == r.shape and rel_rms(y, s) <= 1e-6 and rel_rms(y, r) <= 1e-3


def test_results_outlive_later_groups(small_models):
    """A result is a view of its own group's audio: serving later groups
    neither overwrites it nor hands its memory to another result."""
    _, _, model = small_models
    mels = _mels(6, [8, 8, 16, 8, 16, 8], seed=8)
    it = PipelinedSynthesizer(model, length_buckets=BUCKETS, depth=1, batch=2, device="cpu").stream(mels)
    first = next(it)
    kept = first.copy()
    rest = list(it)
    np.testing.assert_array_equal(first, kept)
    got = [first] + rest  # groups (bucket runs of at most 2): [0, 1], [2], [3], [4], [5]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(got) for b in got[i + 1:])
