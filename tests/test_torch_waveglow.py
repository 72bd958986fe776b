"""WaveGlow on the port's serving path (models/waveglow.py) against the plain
reference `tests/waveglow_reference.py`, at a small size that stays cheap on
the CPU: 4 flows, n_group 8, an early z every 2 flows, WNs of 3 layers at
C=16, T <= 32 frames, seeded weights (the reference's NumPy writer) loaded
through `MELInverter(dir)`.

- the port in fp32 against the reference's fp32 synthesis from the same mel
  and the same z, within 1e-5 rel-RMS: both are the same fp32 arithmetic in
  another order (channels-last products against glow.py's channels-first
  convs, W^-1 inverted in fp32 against fp64), through `synth_from_mel` and
  through `PipelinedSynthesizer` at batch 2;
- the reference's own check: glow.py's training direction then `synth`
  returns the audio within 1e-10 in fp64;
- K1's plain version with a per-layer cond equals the layer loop (route
  "k1" against "layers"); every WN takes route "k1";
- the published configuration builds (on the meta device) with exactly the
  parameter count its equations give, and its FLOP count;
- the spans, and `StreamingSynthesizer`'s refusal.
"""
import copy

import numpy as np
import pytest
import torch

from mbexwn_vocoder_torch import observability
from mbexwn_vocoder_torch.mel_inverter import MELInverter, edge_pad
from mbexwn_vocoder_torch.models import WaveGlow, create_model
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.ops import kernel_lib
from mbexwn_vocoder_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
from mbexwn_vocoder_torch.parallel import StreamingSynthesizer
from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

from tests.test_torch_model import rel_rms
from tests.waveglow_reference import Reference, write_model_dir

torch.set_num_threads(2)

PRE = {"sample_rate": 22050, "hop_size": 256, "win_size": 1024, "fft_size": 1024, "mel_channels": 80,
       "fmin": 0.0, "fmax": 8000.0, "segment_length": 16000}
SMALL = {"preprocess_config": PRE,
         "waveglow_config": {"n_mel_channels": 80, "n_flows": 4, "n_group": 8, "n_early_every": 2, "n_early_size": 2,
                             "sigma": 0.6, "wn_compute_dtype": "float32",
                             "WN_config": {"n_layers": 3, "n_channels": 16, "kernel_size": 3}},
         "weights_seed": 19, "end_scale": 0.05}
PUBLISHED = {"n_mel_channels": 80, "n_flows": 12, "n_group": 8, "n_early_every": 4, "n_early_size": 2, "sigma": 0.6,
             "wn_compute_dtype": "bfloat16", "WN_config": {"n_layers": 8, "n_channels": 256, "kernel_size": 3}}
T_PAD = 32


def mel(T, seed):
    rng = np.random.RandomState(seed)
    band = np.arange(80)[None, :]
    t = np.arange(T)[:, None]
    m = -3.0 - 0.05 * band + 1.5 * np.sin(2 * np.pi * (t / 17.0 + band / 23.0)) + 0.3 * rng.randn(T, 80)
    return m[None].astype(np.float32)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return write_model_dir(SMALL, tmp_path_factory.mktemp("waveglow") / "model")


@pytest.fixture(scope="module")
def reference(model_path):
    return Reference(SMALL, model_path, "cpu")


def test_mel_inverter_matches_reference(model_path, reference):
    inv = MELInverter(str(model_path), device="cpu", length_buckets=(T_PAD,))
    assert isinstance(inv.model, WaveGlow) and inv.noise_shape(mel(30, 1)) == (1, T_PAD * 256 // 8, 8)
    for T, seed in ((30, 1), (T_PAD, 2)):
        m = mel(T, seed)
        y = inv.synth_from_mel(m)
        y_ref = reference.synth(torch.from_numpy(edge_pad(m, T_PAD)))[0, : T * 256].numpy()
        assert y.shape == (T * 256,) and rel_rms(y, y_ref) <= 1e-5, rel_rms(y, y_ref)
    # handed-in noise: the initial z's channels, then the early z's in the order they are prepended
    noise = np.random.RandomState(3).randn(*inv.noise_shape(m)).astype(np.float32)
    y = inv.synth_from_mel(m, noise=noise)
    z = [torch.from_numpy(noise[..., :6]).transpose(1, 2), torch.from_numpy(noise[..., 6:]).transpose(1, 2)]
    y_ref = reference.synth(torch.from_numpy(m), z=z)[0].numpy()
    assert rel_rms(y, y_ref) <= 1e-5, rel_rms(y, y_ref)


def test_pipelined_batch_matches_reference(model_path, reference):
    """A group of 2 draws one (2, channels, T) z per draw, as the reference does."""
    inv = MELInverter(str(model_path), device="cpu")
    synth = PipelinedSynthesizer(inv.model, length_buckets=(T_PAD,), depth=2, batch=2, device="cpu")
    mels = [mel(T_PAD - 5, 4), mel(T_PAD, 5)]
    ys = synth.map(mels)
    y_ref = reference.synth(torch.from_numpy(np.concatenate([edge_pad(m, T_PAD) for m in mels]))).numpy()
    for m, y, r in zip(mels, ys, y_ref):
        n = m.shape[1] * 256
        assert y.shape == (n,) and rel_rms(y, r[:n]) <= 1e-5, rel_rms(y, r[:n])


def test_reference_inverts_its_forward(model_path):
    ref = Reference(SMALL, model_path, "cpu", mode="fp64")
    m = torch.from_numpy(mel(12, 6))
    audio = 0.3 * torch.randn(2, 12 * 256, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    z, log_s, log_det = ref.forward(m.expand(2, -1, -1), audio)
    assert z.shape == (2, 8, 12 * 256 // 8) and len(log_s) == len(log_det) == 4
    back = ref.synth(m.expand(2, -1, -1), z=ref.z_for_synth(z), sigma=1.0)
    assert float((back - audio).abs().max()) <= 1e-10


def test_every_wn_takes_k1_and_the_plain_kernel_equals_the_layer_loop(model_path):
    inv = MELInverter(str(model_path), device="cpu")
    assert [wn.route() for wn in inv.model.WN] == ["k1"] * 4
    wn = copy.deepcopy(inv.model.WN[0])
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 96, 4).astype(np.float32)) * 0.6
    c = torch.from_numpy(np.random.RandomState(9).randn(2, 96, 640).astype(np.float32)) * 0.2
    with torch.no_grad():
        y_k1 = wn(x, c)
        wn.differentiable = True
        assert wn.route() == "layers"
        y_layers = wn(x, c)
    assert rel_rms(y_k1.numpy(), y_layers.numpy()) <= 1e-6
    # the op with a per-layer (B, T, L, 2C) cond: layer i reads slab i, in fp32 and bf16
    wn.differentiable = False
    with torch.no_grad():
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
            xs = wn.start(x.to(dtype))
            cond = wn.conditioning(c.to(dtype))
            assert cond.is_contiguous() and cond.shape == (2, 96, 3 * 32)
            slabs = cond.unflatten(-1, (3, 32))
            got = wavenet_stack(xs, slabs, wn.stack_weights(dtype), wn.dilations)
            assert rel_rms(got.numpy(), wn._layers(xs, cond).float().numpy()) <= tol
            one = wavenet_stack_plain(xs, slabs[:, :, 1], wn.stack_weights(dtype)[1:2], wn.dilations[1:2])
            assert torch.equal(wavenet_stack_plain(xs, slabs[:, :, 1:2], wn.stack_weights(dtype)[1:2],
                                                   wn.dilations[1:2]), one)
        with pytest.raises(ValueError, match="per-layer cond of 2 slabs for 3 layers"):
            wavenet_stack_plain(xs, slabs[:, :, :2], wn.stack_weights(torch.bfloat16), wn.dilations)


def test_fake_op_takes_a_per_layer_cond():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 64, 16)
        cond = torch.empty(2, 64, 3, 32)
        w = (torch.empty(3, 32, 3, 64), torch.empty(3, 32), torch.empty(3, 32, 64), torch.empty(3, 32))
        y = torch.ops.mbexwn.wavenet_stack(x, cond, *w, [1, 2, 4], [False, False, True], "gtu", False)
    assert tuple(y.shape) == (2, 64, 16) and y.dtype == torch.float32


def _equation_params(wg, n_mel=80):
    """Parameters of glow.py's WaveGlow at `wg`, by its equations (weight
    norm folded: one kernel and one bias a conv)."""
    C, L = wg["WN_config"]["n_channels"], wg["WN_config"]["n_layers"]
    G = wg["n_group"]
    total = n_mel * n_mel * 1024 + n_mel
    n_half, n_rem = G // 2, G
    for k in range(wg["n_flows"]):
        if k % wg["n_early_every"] == 0 and k > 0:
            n_half, n_rem = n_half - wg["n_early_size"] // 2, n_rem - wg["n_early_size"]
        total += n_half * C + C  # start
        total += n_mel * G * 2 * C * L + 2 * C * L  # cond
        total += L * (3 * C * 2 * C + 2 * C)  # dilated convs
        total += (L - 1) * (C * 2 * C + 2 * C) + C * C + C  # res/skip, the last skip-only
        total += C * 2 * n_half + 2 * n_half  # end
        total += n_rem * n_rem  # the invertible 1x1 conv
    return total


def test_published_config_parameters_and_flops():
    hp = {"preprocess_config": PRE, "training_config": {}, "waveglow_config": PUBLISHED}
    with torch.device("meta"):
        model, _ = create_model(hp, {}, PRE)
    n = sum(p.numel() for p in model.parameters())
    assert n == _equation_params(PUBLISHED) == 87_731_816
    assert round(sum(p.numel() for p in model.WN[0].parameters()) / 1e6, 2) == 6.77
    assert [wn.end.filters for wn in model.WN] == [8] * 4 + [6] * 4 + [4] * 4
    assert [wn.route() for wn in model.WN] == ["k1"] * 12 and model.early_flows() == [8, 4]
    f = observability.synthesis_flops(model, T_mel=512)
    assert round(f["flops_per_audio_second"] / 1e9) == 448
    assert round(f["breakdown"]["wavenet_layers"] / f["flops_per_call"], 2) == 0.61


def test_spans_and_flows(model_path):
    inv = MELInverter(str(model_path), device="cpu", length_buckets=(T_PAD,))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        inv.synth_from_mel(mel(20, 10))
    names = {e.name for e in prof.events()}
    assert {observability.WAVEGLOW_UPSAMPLE, observability.WAVEGLOW_COUPLING} <= names
    assert {f"mbexwn.model.wavenet.flow{k}" for k in range(4)} <= names


def test_streaming_refuses_waveglow(model_path):
    inv = MELInverter(str(model_path), device="cpu")
    with pytest.raises(ValueError, match="WaveGlow model has no chunked form"):
        StreamingSynthesizer(inv.model, device="cpu")


def test_no_kernel_on_the_cpu(model_path, monkeypatch):
    """The CPU path never builds or launches a kernel."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel library")
    monkeypatch.setattr(kernel_lib, "library", refuse)
    before = dict(kernel_lib.launches)
    MELInverter(str(model_path), device="cpu", length_buckets=(T_PAD,)).synth_from_mel(mel(16, 11))
    assert kernel_lib.launches == before


def test_wavenet_ae_per_layer_k1_without_pre_cond_is_a_row_product():
    """A 1-wide per-layer cond conv gives the row-major (B, T, L * 2C) slab
    (no copy before K1); a 3-wide one stays a conv, equal to it on 1-wide
    weights."""
    net = WaveNetAE(3, 5, n_channels=8, n_layers=2, n_out_channels=4, cond_conv_upsampling=None)
    c = torch.randn(2, 10, 5)
    with torch.no_grad():
        rows = net.conditioning(c)
        conv = net.cond(c)
    assert rows.is_contiguous() and rows.shape == (2, 10, 32) and rel_rms(rows.numpy(), conv.numpy()) <= 1e-6
