"""The port's diagnostics (observability.py) on the CPU: `synthesis_flops`
against the JAX package's for the three registry models and the tiny
config, `dump_controls` (keys and shapes of `infer_components`'s signals),
`debug_nans` (raises at the first op whose output holds a NaN, silent
otherwise, nests as the JAX flag does) and `profile_trace` (writes a
trace file that names the synthesis's ops)."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.observability import synthesis_flops as jax_synthesis_flops

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.iovar import load_var
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.observability import debug_nans, dump_controls, profile_trace, synthesis_flops
from mbexwn_vocoder_torch.training.parity import tiny_hparams

torch.set_num_threads(2)
T_MEL, HOP = 8, 300


def _hparams(name):
    return tiny_hparams() if name == "tiny" else read_config(get_config_file(name))


@pytest.mark.parametrize("name", ["SPEECH", "SING", "VOICE", "tiny"])
def test_synthesis_flops_equal_jax(name):
    hp = _hparams(name)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    for T_mel, batch in ((1, 1), (512, 1), (100, 8)):
        got, want = synthesis_flops(model, T_mel, batch), jax_synthesis_flops(jmodel, T_mel, batch)
        assert got == want, (T_mel, batch, got, want)
    assert got["breakdown"]["wavenet"] > 0


@pytest.fixture(scope="module")
def tiny_model():
    hp = tiny_hparams(**{"mbexwn_config.normalize_rms_from_mell": True})
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.init(torch.Generator().manual_seed(0))
    return model.eval()


def _mel(seed=0):
    return (np.random.RandomState(seed).randn(1, T_MEL, 80) * 0.5 - 4).astype(np.float32)


def test_dump_controls_writes_the_jax_keys(tiny_model, tmp_path):
    blk = tiny_model.block
    path = str(tmp_path / "controls.pkl")
    noise = np.random.RandomState(1).randn(1, blk.wn_input_length(T_MEL), 1).astype(np.float32)
    data = dump_controls(path, tiny_model, _mel(), noise=noise)
    saved = load_var(path)
    assert sorted(saved) == sorted(data) == ["PulseFilterSpectrum", "pulse_frequency", "pulse_signal",
                                             "upsampled_rms"]
    assert saved["pulse_frequency"].shape == (1, T_MEL * blk.spect_to_pulse_upsampling_factor)
    assert saved["pulse_signal"].shape == (1, T_MEL * HOP)
    assert saved["PulseFilterSpectrum"].shape == (1, T_MEL, blk.fft_size // 2 + 1)
    assert saved["upsampled_rms"].shape == (1, T_MEL * HOP)
    assert (saved["PulseFilterSpectrum"] >= 0).all() and all(np.isfinite(v).all() for v in saved.values())
    with torch.no_grad():
        F0, excitation, _, _ = tiny_model.infer_components(torch.from_numpy(_mel()), noise=torch.from_numpy(noise))
    assert np.array_equal(saved["pulse_frequency"], F0.numpy())
    assert np.array_equal(saved["pulse_signal"], excitation.numpy())


def test_debug_nans_raises_at_the_first_nan_and_nests(tiny_model):
    mel = torch.from_numpy(_mel())
    with torch.no_grad():
        ref = tiny_model.infer(mel, synth_length=T_MEL * HOP)
        with debug_nans():
            y = tiny_model.infer(mel, synth_length=T_MEL * HOP)  # silent on a clean synthesis
        assert torch.equal(y, ref)
        bad = mel.clone()
        bad[0, 3, 7] = float("nan")
        with pytest.raises(FloatingPointError, match=r"debug_nans: aten\.\w+.* produced a NaN"):
            with debug_nans():
                tiny_model.infer(bad, synth_length=T_MEL * HOP)
        # an inner disabled scope turns the check off, and leaving it turns it back on
        nan = torch.full((2,), float("nan"))
        with debug_nans():
            with debug_nans(False):
                assert torch.isnan(nan * 2).all()
                with debug_nans():
                    with pytest.raises(FloatingPointError, match="aten.mul"):
                        nan * 2
                assert torch.isnan(nan * 2).all()
            with pytest.raises(FloatingPointError, match="aten.mul"):
                nan * 2
        assert torch.isnan(nan * 2).all()  # outside every scope


def test_debug_nans_names_a_kernel_op(tiny_model):
    """The kernels' ops are visible to the check: a NaN that first appears
    in the WaveNet stack's output is reported at mbexwn::wavenet_stack."""
    from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack

    wn = getattr(tiny_model.block, tiny_model.block.block_names[0]).wavenet
    with torch.no_grad():
        packed = wn.stack_weights(torch.float32)
        w_dil = packed.w_dil.clone()
        w_dil[0, 0, 0, 0] = float("nan")
        x = torch.randn(1, 40, wn.n_channels)
        cond = torch.randn(1, 40, 2 * wn.n_channels)
        with pytest.raises(FloatingPointError, match="mbexwn.wavenet_stack"):
            with debug_nans():
                wavenet_stack(x, cond, dataclasses.replace(packed, w_dil=w_dil), wn.dilations)


def test_profile_trace_writes_a_trace(tiny_model, tmp_path):
    log_dir = str(tmp_path / "trace")
    with torch.no_grad(), profile_trace(log_dir) as prof:
        tiny_model.infer(torch.from_numpy(_mel()), synth_length=T_MEL * HOP)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 1000
    with open(files[0]) as f:
        text = f.read()
    assert "mbexwn::wavenet_stack" in text and "mbexwn::oscillate" in text
    assert any(e.key == "mbexwn::wavenet_stack" for e in prof.key_averages())


# ---------------------------------------------------------------- spans

def _stage_spans(block):
    """The model's stage spans of one synthesis from a given F0, in order."""
    return (["mbexwn.model.normmel", "mbexwn.model.excitation"] + block.block_spans
            + ["mbexwn.model.post_pqmf", "mbexwn.model.envelope"])


def _profiled(fn):
    """(fn's result, the `mbexwn.` and `test.` ranges it recorded on this
    thread as (name, start_ns, end_ns, parent's name or None), in start
    order) with `torch.profiler` recording the CPU."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(("mbexwn.", "test."))), key=lambda r: (r[1], -r[2]))
    spans, stack = [], []
    for name, s, e in evs:
        while stack and stack[-1][2] < s:
            stack.pop()
        spans.append((name, s, e, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out, spans


def _mels(n, lo=6):
    return [(np.random.RandomState(i).randn(1, lo + i, 80) * 0.5 - 4).astype(np.float32) for i in range(n)]


def _serve(model, consumer=None, n=3, batch=2):
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

    out = []
    for y in PipelinedSynthesizer(model, length_buckets=(T_MEL,), depth=2, batch=batch, device="cpu").stream(_mels(n)):
        out.append(y)
        if consumer is not None:
            consumer()
    return out


def _stream(model, consumer=None):
    from mbexwn_vocoder_torch.parallel.streaming import StreamingSynthesizer

    ss = StreamingSynthesizer(model, chunk_frames=4, halo_frames=4, halo_right=2, device="cpu")
    mel = _mels(1, lo=20)[0]
    out = []
    for audio in ss.stream(mel[:, i: i + 2] for i in range(0, 20, 2)):
        out.append(audio)
        if consumer is not None:
            consumer()
    return out


def _infer(model):
    with torch.no_grad():
        return model.infer(torch.from_numpy(_mel()), synth_length=T_MEL * HOP)


def test_infer_spans_are_the_model_stages_in_order(tiny_model):
    _, spans = _profiled(lambda: _infer(tiny_model))
    blk = tiny_model.block
    assert [s[0] for s in spans] == ["mbexwn.model.normmel", "mbexwn.model.f0_net", "mbexwn.model.excitation",
                                     *blk.block_spans, "mbexwn.model.post_pqmf", "mbexwn.model.envelope"]
    assert blk.block_spans == ["mbexwn.model.wavenet." + n for n in blk.block_names] and len(blk.block_names) == 2
    assert all(s[3] is None for s in spans)  # the stages do not nest


def test_serving_spans_dispatch_each_group_and_wait_on_it(tiny_model):
    _, spans = _profiled(lambda: _serve(tiny_model))
    top = [s[0] for s in spans if s[3] is None]
    # 3 utterances at batch 2: two groups, each dispatched, then (depth 2) collected in order
    assert top == ["mbexwn.serving.dispatch", "mbexwn.serving.dispatch", "mbexwn.serving.collect_wait",
                   "mbexwn.serving.collect_wait"]
    inner = [s[0] for s in spans if s[3] == "mbexwn.serving.dispatch"]
    one = ["mbexwn.model.normmel", "mbexwn.model.f0_net", *_stage_spans(tiny_model.block)[1:]]
    assert inner == one + one
    assert not any(s[3] == "mbexwn.serving.collect_wait" for s in spans)


def test_stream_spans_enqueue_and_read_back_each_chunk(tiny_model):
    chunks, spans = _profiled(lambda: _stream(tiny_model))
    top = [s[0] for s in spans if s[3] is None]
    assert top == ["mbexwn.stream.enqueue", "mbexwn.stream.readback"] * len(chunks) and len(chunks) == 5
    # a chunk: the carry's F0 (normalised mel, F0 net), then the synthesis from that F0
    one = ["mbexwn.model.normmel", "mbexwn.model.f0_net", *_stage_spans(tiny_model.block)]
    assert [s[0] for s in spans if s[3] == "mbexwn.stream.enqueue"] == one * len(chunks)
    assert not any(s[3] == "mbexwn.stream.readback" for s in spans)


@pytest.mark.parametrize("mode", ["serve", "stream"])
def test_no_span_is_open_while_a_stream_yields(tiny_model, mode):
    """Work the consumer does between two results falls under no span."""

    def consume():
        with torch.profiler.record_function("test.consumer"):
            torch.ones(4).mul(3)

    out, spans = _profiled(lambda: _serve(tiny_model, consume, n=4, batch=1) if mode == "serve"
                           else _stream(tiny_model, consume))
    consumers = [s for s in spans if s[0] == "test.consumer"]
    assert len(consumers) == len(out) > 2
    assert all(s[3] is None for s in consumers)


def test_outputs_are_bit_equal_with_the_profiler_on_and_off(tiny_model):
    for fn in (_infer, _serve, _stream):
        off = fn(tiny_model)
        on, spans = _profiled(lambda: fn(tiny_model))
        assert spans
        off, on = (off if isinstance(off, list) else [off]), (on if isinstance(on, list) else [on])
        assert len(off) == len(on) and all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(off, on))


def _count_records(monkeypatch):
    """The names `span` opens a profiler range for, from now on."""
    from mbexwn_vocoder_torch import observability

    entered = []
    real = observability._record_function
    monkeypatch.setattr(observability, "_record_function", lambda name: entered.append(name) or real(name))
    return entered


def test_span_enters_record_function_only_while_a_profiler_records(tiny_model, monkeypatch):
    from mbexwn_vocoder_torch import observability

    entered = _count_records(monkeypatch)
    for fn in (_infer, _serve, _stream):
        fn(tiny_model)
    assert entered == []
    with observability.span("mbexwn.test"):
        pass
    assert entered == [] and observability.span("a") is observability.span("b")
    _profiled(lambda: _infer(tiny_model))
    assert entered[:2] == ["mbexwn.model.normmel", "mbexwn.model.f0_net"]


def test_export_under_a_profiler_holds_no_profiler_op(tiny_model, monkeypatch):
    """`torch.export` traces with the profiler recording: the spans stay out
    of the graph (they do nothing while export traces) and the artifact
    computes what the model does."""
    import io

    from mbexwn_vocoder_torch.compat.export import _read_meta, export_synthesis, load_exported

    entered = _count_records(monkeypatch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        blob = export_synthesis(tiny_model, T_mel=T_MEL, batch_size=1, platforms=["cpu"])
    assert entered == []
    meta, start = _read_meta(blob)
    program = torch.export.load(io.BytesIO(blob[start: start + meta["program_bytes"][0]]))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    call, _ = load_exported(blob, device="cpu")
    assert torch.equal(call(_mel()), _infer(tiny_model))


def test_a_span_is_a_host_op_range_not_a_user_annotation(tiny_model):
    """A span is recorded as an op-scope range: the profiler adds no
    device-side range over the kernels it encloses (it does for a
    user-scope `record_function`), which a reader of the device's activity
    would count as device work."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _infer(tiny_model)
    ours = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("mbexwn.")]
    assert len(ours) == 5 + len(tiny_model.block.block_names)
    assert not any(e.is_user_annotation() for e in ours)
