"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU and the CUDA toolkit (the kernels are built at
first use) and skip elsewhere.  On a machine with a card:

    python -m pytest -m cuda tests/test_torch_cuda.py

chip_smoke.py holds the kernels against the plain versions at the main
path's shapes; these cover the edges.  K1: batch > 1, ragged time tiles, a
dilation wider than the utterance, an utterance shorter than one 128-row
tile, channel counts that are not multiples of the 64-wide reduction slices
or of the column chunks, and the two host entries against each other.  K2:
ragged lengths, batch > 1, a phase offset, the phase it returns (bit-equal
to the plain version's on the card and on the CPU), tables of other sizes
(one past 48 KB of shared memory), more chunks than CTAs resident at once,
and one launch per call.  K3 (the post net and the PQMF synthesis): an
offline group's and a live span's shapes, batch > 1, tiles cut short, the
gains, 8 and 10 input channels, a partial synthesis, 4 and 8 bands,
against the plain version within 1e-6; a CUDA graph's replay bit-equal to
the eager launch; a SPEECH synthesis launches it once, WaveGlow and the
training route never.  Serving (SPEECH's registry weights, full width):
the pipeline at batch 1 bit-equal to the blocking loop, a group's dispatch
free of host-device synchronisation, a batch of 8 against single requests
handed the same noise rows, and BatchSynthesizer at B = 8 in the 2048
bucket against the plain K1 path (the largest shapes the kernels see).
Streaming: K1's causal taps against the plain version (ragged batches, both
host entries), and synth_batched and stream() of a full-width causal SPEECH
on the card against the same with K1 replaced by its plain version and
against the CPU.  Live chunks as CUDA graphs (causal SPEECH, chunk 16,
halo 32 + 2): two sessions interleaved through the ramp, the steady state
and the tail flush give audio, carries and F0-net outputs bit-equal to the
eager path; a replayed chunk makes at most 120 launch calls and counts no
kernel launch; K2 captured in a graph equals its eager launch.  Training: both kernels raise on CUDA inputs that require
grad (they have no backward pass), one step of the trainer's
differentiable route on the card equals the CPU's (`training.parity` gives
the rule), and a trained model, folded, synthesises through both kernels.
The training CLI: two steps (`cli.train`) on the card with a
tiny config, whose export synthesises through both kernels; one adversarial
step on the card equals the CPU's.  Two cards (skipped with fewer): both
kernels launch on cuda:1 after cuda:0, under the tensors' device.  The
kernels as `torch.library` ops launch or raise on CUDA tensors; a tiny
model's exported program on the card launches both and equals the model's
synthesis; the fp64 remat step on the card equals the step without.  Every
route of the WaveNet stack: the branches the kernel does not take (gates
glu/gfu/gsu, channel groups, kernel size 5) synthesise on the card as on
the CPU without a K1 launch; tensor parallelism over a model axis of the
one card equals the unsharded model; the int8 products at the registry
widths are exact and the int8 mode equals the CPU's.  Per-layer
conditioning (WaveGlow's WN: C=256, 8 layers, dilations 2^i): K1 with a
(B, T, L, 2C) cond against the plain version at batch 1 and 8 of a
1024-frame bucket (bf16 2e-2, fp32 1e-4); a per-layer cond whose slabs are
all equal gives the shared call's output bit for bit (C = 256, 320, 340);
WaveGlow at its published widths synthesises with 96 K1 launches, its
fp32 synthesis within 1e-4 of the plain reference's on the card.  A shared
cond at the frame rate (U = 25, C = 256, 320, 340, batch 8, 1024 frames and
an odd count, SAME and causal, fp32 and bf16): K1 gives its output on the
upsampler's full-rate slab bit for bit, and a SPEECH synthesis (two such
calls) gives the audio of the same synthesis with the interpolation outside
K1 bit for bit.
"""
import re

import numpy as np
import pytest
import torch

from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.ops import kernel_lib
from mbexwn_vocoder_torch.ops.interp import linear_interp_upsample, pad_end
from mbexwn_vocoder_torch.ops.oscillator import oscillate, oscillate_plain
from mbexwn_vocoder_torch.ops.post_pqmf import post_pqmf, post_pqmf_plain
from mbexwn_vocoder_torch.ops.precision import exact_fp32
from mbexwn_vocoder_torch.ops.wavenet_stack import (pack_stack_weights, wavenet_layer, wavenet_stack,
                                                     wavenet_stack_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(C, B, T, dils, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, T, C, generator=g) * 0.3).to(device, dtype)
    cond = (torch.randn(B, T, 2 * C, generator=g) * 0.2).to(device, dtype)
    weights = []
    for i in range(len(dils)):
        out = C if i == len(dils) - 1 else 2 * C
        scale = 1.0 / np.sqrt(3 * C)
        weights.append(tuple(t.to(device, dtype) for t in (
            torch.randn(2 * C, 3, C, generator=g) * scale, torch.randn(2 * C, generator=g) * 0.05,
            torch.randn(out, C, generator=g) * scale, torch.randn(out, generator=g) * 0.05)))
    return x, cond, weights


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C,B,T,dils", [(8, 2, 100, (1, 2, 64, 128)), (68, 3, 257, (1, 16, 4)),
                                        (340, 2, 130, (1, 2, 4, 8, 16, 32, 64, 1, 2, 4, 8, 16)),
                                        (340, 2, 50, (64, 1, 64)), (340, 2, 391, (1, 64, 16, 4)),
                                        (320, 2, 257, (32, 2, 64))])
def test_k1_matches_plain(card, C, B, T, dils, dtype, tol):
    x, cond, weights = _case(C, B, T, dils, dtype, card)
    before = kernel_lib.launches["wavenet_layer"]
    with exact_fp32():
        got = wavenet_stack(x, cond, weights, dils)
        ref = wavenet_stack_plain(x, cond, weights, dils)
    torch.cuda.synchronize()
    assert kernel_lib.launches["wavenet_layer"] - before == len(dils)
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    assert torch.isfinite(got).all() and rel <= tol, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_stack_entry_equals_layer_entry(card, dtype):
    """One host call for the stack enqueues what the per-layer entry enqueues
    layer by layer: the same skip sum, bit for bit."""
    C, B, T, dils = 340, 2, 300, (1, 64, 4, 16, 2)
    x, cond, weights = _case(C, B, T, dils, dtype, card, seed=3)
    packed = pack_stack_weights(weights)
    before = kernel_lib.launches["wavenet_layer"]
    whole = wavenet_stack(x, cond, packed, dils)
    assert kernel_lib.launches["wavenet_layer"] - before == len(dils)
    bufs = torch.zeros((2, B, T, packed.C_pad), dtype=dtype, device=card)
    bufs[0, :, :, :C] = x
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=card)
    for i, ((wd, bd, wr, br), d) in enumerate(zip(packed, dils)):
        wavenet_layer(bufs[i % 2], cond, wd, bd, wr, br, bufs[(i + 1) % 2], skip, d)
    torch.cuda.synchronize()
    assert kernel_lib.launches["wavenet_layer"] - before == 2 * len(dils)
    assert torch.equal(whole, skip)
    # the pad columns of the ping-pong buffers are still zero
    assert not bufs[..., C:].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C,B,T,dils", [(8, 2, 100, (1, 2, 64, 128)), (340, 2, 391, (1, 64, 16, 4)),
                                        (320, 3, 257, (32, 2, 64)), (320, 1, 50, (64, 1))])
def test_k1_causal_matches_plain(card, C, B, T, dils, dtype, tol):
    x, cond, weights = _case(C, B, T, dils, dtype, card, seed=5)
    before = kernel_lib.launches["wavenet_layer"]
    with exact_fp32():
        got = wavenet_stack(x, cond, weights, dils, causal=True)
        ref = wavenet_stack_plain(x, cond, weights, dils, causal=True)
        same = wavenet_stack_plain(x, cond, weights, dils)
    torch.cuda.synchronize()
    assert kernel_lib.launches["wavenet_layer"] - before == len(dils)
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    assert torch.isfinite(got).all() and rel <= tol, rel
    assert float(torch.sqrt(torch.mean((got - same) ** 2) / torch.mean(same ** 2))) > 10 * tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_causal_stack_entry_equals_layer_entry(card, dtype):
    C, B, T, dils = 320, 2, 300, (1, 64, 4, 16, 2)
    x, cond, weights = _case(C, B, T, dils, dtype, card, seed=6)
    packed = pack_stack_weights(weights)
    whole = wavenet_stack(x, cond, packed, dils, causal=True)
    bufs = torch.zeros((2, B, T, packed.C_pad), dtype=dtype, device=card)
    bufs[0, :, :, :C] = x
    skip = torch.zeros((B, T, C), dtype=torch.float32, device=card)
    for i, ((wd, bd, wr, br), d) in enumerate(zip(packed, dils)):
        wavenet_layer(bufs[i % 2], cond, wd, bd, wr, br, bufs[(i + 1) % 2], skip, d, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(whole, skip)


def test_k1_leaves_its_input_alone(card):
    x, cond, weights = _case(16, 1, 70, (1, 2, 4), torch.bfloat16, card)
    x0 = x.clone()
    wavenet_stack(x, cond, weights, (1, 2, 4))
    torch.cuda.synchronize()
    assert torch.equal(x, x0)


def test_k1_refuses_what_it_does_not_take(card):
    x, cond, weights = _case(6, 1, 16, (1,), torch.bfloat16, card)
    with pytest.raises(ValueError, match="C % 4"):
        wavenet_stack(x, cond, weights, (1,))
    x, cond, weights = _case(8, 1, 16, (1,), torch.float16, card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wavenet_stack(x, cond, weights, (1,))


@pytest.mark.parametrize("B,T,n_wt,n_grid,with_offset", [
    (3, 5001, 513, 13, False), (1, 76_800, 513, 13, False), (3, 12_345, 513, 13, True), (2, 999, 257, 9, True),
    (1, 1, 513, 13, True), (1, 20_000, 2049, 13, False), (4, 300_000, 129, 7, True)])
def test_k2_matches_plain(card, B, T, n_wt, n_grid, with_offset):
    g = torch.Generator().manual_seed(B * T + n_wt)
    tables = torch.randn(n_wt, n_grid, generator=g)
    f0 = 40.0 + 560.0 * torch.rand(B, T, generator=g)
    offset = torch.rand(B, generator=g) - 0.5 if with_offset else None
    consts = (46.875, 1.25, 1.0, 1.25 ** (n_grid - 1), 12000.0)
    on_card = (f0.to(card), tables.to(card), None if offset is None else offset.to(card))
    before = kernel_lib.launches["oscillator"]
    got, phase = oscillate(on_card[0], on_card[1], *consts, phase_offset=on_card[2], return_phase=True)
    torch.cuda.synchronize()
    assert kernel_lib.launches["oscillator"] - before == 1
    audio_only = oscillate(on_card[0], on_card[1], *consts, phase_offset=on_card[2])
    ref, ref_phase = oscillate_plain(on_card[0], on_card[1], *consts, phase_offset=on_card[2], return_phase=True)
    cpu_phase = oscillate_plain(f0, tables, *consts, phase_offset=offset, return_phase=True)[1]
    torch.cuda.synchronize()
    assert kernel_lib.launches["oscillator"] - before == 2
    assert torch.equal(phase, ref_phase) and torch.equal(phase.cpu(), cpu_phase)
    assert torch.equal(audio_only, got)
    assert float((got - ref).abs().max()) <= 1e-5


def test_k2_refuses_what_it_does_not_take(card):
    f0 = torch.full((2, 100), 100.0, device=card)
    tables = torch.randn(513, 13, device=card)
    consts = (46.875, 1.25, 1.0, 1.25 ** 12, 12000.0)
    with pytest.raises(ValueError, match="does not fit"):
        oscillate(f0, torch.zeros(8193, 8, device=card), *consts)
    with pytest.raises(ValueError, match="16-byte boundary"):
        oscillate(f0, torch.randn(6670, device=card)[1:].view(513, 13), *consts)
    with pytest.raises(ValueError, match="contiguous float32"):
        oscillate(f0.t().contiguous().t(), tables, *consts)
    with pytest.raises(ValueError, match="are not"):
        oscillate(f0, tables, *consts, phase_offset=torch.zeros(3, device=card))


def _k3_case(B, T, cin, device, S=6, taps=94, cutoff=0.0945, max_band=None, bias=True, equalized_lr=False,
             mb_gain=False, channel_major=False, seed=0):
    """K3's arguments: x (B, T, cin) (channel_major: a view of a contiguous
    (B, cin, T), as the WaveNet's end conv leaves it), a post net (S, cin)
    with its bias and post gain or None, a multiband gain with 3 rows more
    than T or None, and the PQMF synthesis bank of S bands and `taps` taps."""
    from mbexwn_vocoder_torch.dsp.pqmf import pqmf_filters

    g = torch.Generator().manual_seed(seed + B * T + cin)
    x = 0.5 * torch.randn(B, T, cin, generator=g)
    weight = torch.randn(S, cin, generator=g) / np.sqrt(cin)
    b = 0.1 * torch.randn(S, generator=g) if bias else None
    gain = 1.0 + 0.2 * torch.randn(S, generator=g) if equalized_lr else None
    mb = torch.exp(0.3 * torch.randn(B, T + 3, S, generator=g)) if mb_gain else None
    _, syn = pqmf_filters(S, taps, cutoff, 9.0, max_band)
    filt = torch.from_numpy(np.ascontiguousarray(syn.transpose(2, 1, 0)))
    if channel_major:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    return tuple(None if t is None else t.to(device) for t in (x, weight, b, gain, mb, filt)) + (S, filt.shape[1])


@pytest.mark.parametrize("B,T,cin,kw", [
    (8, 51_200, 64, dict(channel_major=True)),  # an offline group, batch 8 x bucket 1024, as the model lays x out
    (1, 2_500, 64, dict(channel_major=True)),  # a live chunk's span: 50 frames
    (8, 51_200, 64, {}),  # rows contiguous
    (3, 2_501, 64, dict(mb_gain=True, equalized_lr=True, channel_major=True)),  # T % 4 != 0: 4-byte copies
    (2, 1, 64, {}), (2, 7, 8, dict(bias=False)),  # shorter than a tile; the tiny configs' 8 channels
    (2, 1000, 10, dict(mb_gain=True)),  # a row of 40 bytes: 4-byte copies
    (2, 777, 64, dict(max_band=4, mb_gain=True)),
    (1, 3_000, 64, dict(S=4, taps=62, cutoff=0.142)),  # 16 taps a phase, 4 bands
    (1, 3_000, 64, dict(S=8, taps=62, cutoff=0.071)),  # 8 taps a phase, 8 bands
], ids=["offline_group", "live_span", "offline_group_rows", "gains", "T1", "cin8_no_bias", "cin10", "max_band4",
        "S4_taps62", "S8_taps62"])
def test_k3_matches_plain(card, B, T, cin, kw):
    """K3 against post_pqmf_plain on the card (true fp32): within 1e-6
    rel-RMS (the order of fp32 sums only), one launch a call."""
    args = _k3_case(B, T, cin, card, **kw)
    before = kernel_lib.launches["post_pqmf"]
    with exact_fp32():
        got = post_pqmf(*args)
        ref = post_pqmf_plain(*args)
    torch.cuda.synchronize()
    assert kernel_lib.launches["post_pqmf"] - before == 1
    assert got.shape == ref.shape == (B, T * args[-2])
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    assert torch.isfinite(got).all() and rel <= 1e-6, rel


@pytest.mark.parametrize("B,T", [(1, 2_500), (8, 51_200)])
def test_k3_in_a_cuda_graph_equals_its_eager_launch(card, B, T):
    """K3 captured in a CUDA graph: each replay equals the eager launch on
    the inputs then in its buffers, bit for bit."""
    x, *rest = _k3_case(B, T, 64, card, mb_gain=True, channel_major=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = kernel_lib.launches["post_pqmf"]
    with torch.cuda.graph(graph, stream=side):
        out = post_pqmf(x, *rest)
    assert kernel_lib.launches["post_pqmf"] - before == 1
    g = torch.Generator().manual_seed(T)
    for step in range(2):
        if step:
            x.copy_(0.5 * torch.randn(x.shape, generator=g))  # in place: the layout stays channel-major
            rest[3].copy_(torch.exp(0.3 * torch.randn(rest[3].shape, generator=g)))
        graph.replay()
        want = post_pqmf(x, *rest)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_k3_refuses_what_it_does_not_take(card):
    x, weight, bias, gain, mb, filt, S, used = _k3_case(1, 100, 64, card)
    with pytest.raises(ValueError, match="8 used bands"):
        post_pqmf(*_k3_case(1, 100, 64, card, S=10, taps=94, cutoff=0.05)[:6], 10, 10)
    with pytest.raises(ValueError, match="taps a phase"):
        post_pqmf(*_k3_case(1, 100, 64, card, S=2, taps=94, cutoff=0.25)[:6], 2, 2)
    with pytest.raises(ValueError, match="float32"):
        post_pqmf(x.bfloat16(), weight, bias, gain, mb, filt, S, used)
    with pytest.raises(ValueError, match="on cuda"):
        post_pqmf(x, weight.cpu(), bias, gain, mb, filt, S, used)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        post_pqmf(x, weight, bias, gain, mb, filt, S, used)
    with torch.inference_mode():
        post_pqmf(x, weight, bias, gain, mb, filt, S, used)
    torch.cuda.synchronize()


# ---- serving on the card: the registry's SPEECH at full width (fp32 unless a test says otherwise)

def _mel(T, seed):
    rng = np.random.RandomState(seed)
    band, t = np.arange(80)[None, :], np.arange(T)[:, None]
    return (-2.0 - 0.06 * band + np.sin(2 * np.pi * t / 53.0) + 0.3 * rng.randn(T, 80))[None].astype(np.float32)


def _noise_rows(inv, lengths, device):
    """The noise a dispatch group of these lengths draws: a generator seeded
    0, shape (B, L, 1) on the card; one row per request."""
    L = inv.model.block.wn_input_length(inv._bucket_len(max(lengths)))
    noise = torch.randn((len(lengths), L, 1), generator=torch.Generator(device=device).manual_seed(0),
                        device=device).cpu().numpy()
    return [noise[i:i + 1] for i in range(len(lengths))]


def _rel(a, b):
    return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2) / np.mean(b.astype(np.float64) ** 2)))


def test_pipelined_batch1_equals_blocking(card):
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

    inv = MELInverter("SPEECH")
    mels = [_mel(T, i) for i, T in enumerate((100, 300, 64, 250, 129))]
    before = dict(kernel_lib.launches)
    got = PipelinedSynthesizer(inv.model, inv.length_buckets, depth=3, batch=1).map(mels)
    assert kernel_lib.launches["oscillator"] - before["oscillator"] == len(mels)
    assert kernel_lib.launches["wavenet_layer"] - before["wavenet_layer"] == 24 * len(mels)
    for m, y in zip(mels, got):
        assert np.array_equal(y, inv.synth_from_mel(m))


def test_pipelined_dispatch_does_not_synchronize(card):
    """Enqueueing a group (copy in, synthesis, copy out, event) runs no
    PyTorch op that waits for the card."""
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

    inv = MELInverter("SPEECH")
    ps = PipelinedSynthesizer(inv.model, inv.length_buckets, depth=2, batch=4)
    group = [(ps._prep(_mel(T, i))[0], T) for i, T in enumerate((200, 256, 180))]
    ps._collect(*ps._dispatch_group(group, 256))  # warm-up
    torch.cuda.set_sync_debug_mode("error")
    try:
        inflight = ps._dispatch_group(group, 256)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [y.shape for y in ps._collect(*inflight)] == [(T * 300,) for _, T in group]


@pytest.mark.parametrize("dtype,tol", [("", 1e-4), (None, 2e-2)])
def test_batch8_matches_singles_with_their_noise_rows(card, monkeypatch, dtype, tol):
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        if dtype is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, dtype)
    inv = MELInverter("SPEECH")
    mels = [_mel(T, 10 + i) for i, T in enumerate((65, 128, 100, 77, 128, 90, 111, 70))]
    got = PipelinedSynthesizer(inv.model, inv.length_buckets, depth=2, batch=8).map(mels)
    rows = _noise_rows(inv, [m.shape[1] for m in mels], card)
    errs = [_rel(y, inv.synth_from_mel(m, noise=n)) for y, m, n in zip(got, mels, rows)]
    assert max(errs) <= tol, errs


def test_batch_synthesizer_b8_bucket2048_matches_plain_k1(card, monkeypatch):
    """Eight utterances in the 2048 bucket, fp32: 8 x 102,400 rows in WaveNet
    block 1 and 8 x 307,200 samples of oscillator (2,464 chunks), against the
    same synthesis with K1 replaced by its plain version (same noise)."""
    import mbexwn_vocoder_torch.nn.wavenet as wavenet
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.parallel.batch import BatchSynthesizer

    inv = MELInverter("SPEECH")
    mels = [_mel(T, 20 + i)[0] for i, T in enumerate((2048, 1900, 1500, 2000, 1100, 1700, 2048, 1300))]
    bs = BatchSynthesizer(inv.model, length_buckets=(2048,))
    before = kernel_lib.launches["wavenet_layer"]
    got = bs.synth_batch(mels)
    assert kernel_lib.launches["wavenet_layer"] - before == 24
    monkeypatch.setattr(wavenet, "wavenet_stack", wavenet_stack_plain)
    ref = bs.synth_batch(mels)
    assert kernel_lib.launches["wavenet_layer"] - before == 24
    for y, r, m in zip(got, ref, mels):
        assert y.shape == r.shape == (m.shape[0] * 300,) and np.isfinite(y).all()
        assert _rel(y, r) <= 1e-4


@pytest.mark.parametrize("mode", ["synth_batched", "stream"])
def test_causal_streaming_on_the_card(card, monkeypatch, mode):
    """Full-width causal SPEECH with the noise channel off (the shipped
    weights, `create_registry_model`), fp32, 150 frames in chunks of 32 with
    halo 32 and halo_right 2, B = 2: on the card against the same with K1
    replaced by its plain version (1e-4) and against the CPU (1e-3, the
    card-vs-CPU budget of a whole synthesis)."""
    import mbexwn_vocoder_torch.nn.wavenet as wavenet
    from mbexwn_vocoder_torch.models import create_registry_model
    from mbexwn_vocoder_torch.parallel import StreamingSynthesizer

    kw = dict(force_causal=True, pp_mod_subnet_noise_channel_sigma=0, normalize_rms_from_mell=False)
    geometry = dict(chunk_frames=32, halo_frames=32, halo_right=2)
    mel = np.concatenate([_mel(150, 30), _mel(150, 31)])

    def run(ss):
        if mode == "stream":
            return np.concatenate(list(ss.stream(mel[:, i:i + 5] for i in range(0, 150, 5))), axis=1)
        return ss.synth_batched(mel)

    ss = StreamingSynthesizer(create_registry_model("SPEECH", **kw), device=card, **geometry)
    before = dict(kernel_lib.launches)
    got = run(ss)
    n_chunks = -(-150 // 32)
    groups = n_chunks if mode == "stream" else 3  # synth_batched: one batch per chunk shape
    assert kernel_lib.launches["wavenet_layer"] - before["wavenet_layer"] == 24 * groups
    assert kernel_lib.launches["oscillator"] - before["oscillator"] == groups
    cpu = run(StreamingSynthesizer(create_registry_model("SPEECH", **kw), device="cpu", **geometry))
    monkeypatch.setattr(wavenet, "wavenet_stack", wavenet_stack_plain)
    plain = run(ss)
    assert got.shape == plain.shape == cpu.shape == (2, 150 * 300) and np.isfinite(got).all()
    assert _rel(got, plain) <= 1e-4
    assert _rel(got, cpu) <= 1e-3


# ---- live chunks as CUDA graphs: causal SPEECH (shipped weights, noise on), chunk 16, halo 32 + 2

LIVE = dict(chunk_frames=16, halo_frames=32, halo_right=2)
LAUNCH_CALL = re.compile(r"^(cuda|cu)(LaunchKernel|LaunchCooperativeKernel|LaunchKernelEx|GraphLaunch)")


def _live_model(monkeypatch, dtype):
    from mbexwn_vocoder_torch.models import create_registry_model

    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        if dtype is None:
            monkeypatch.delenv(var, raising=False)  # the registry config's bf16
        else:
            monkeypatch.setenv(var, dtype)
    return create_registry_model("SPEECH", force_causal=True)


def _slabs(mel, slab):
    return (mel[:, i:i + slab] for i in range(0, mel.shape[1], slab))


def _interleaved(ss, mels, slab=2):
    """Two live sessions on one synthesizer, a chunk of each in turn, through
    the ramp, the steady state and the tail flush -> per session, the
    (audio, carry) of each chunk, and the F0 net's outputs in call order."""
    log, f0s, current = {}, [], [None]
    real = ss._chunk

    def chunk(mel_span, carry, left, inner):
        audio, carry = real(mel_span, carry, left, inner)
        log[current[0]].append((audio.cpu().numpy().copy(), carry.cpu().numpy().copy()))
        return audio, carry

    ss._chunk = chunk
    handle = ss.model.block.pp_subnet.register_forward_hook(lambda m, i, o: f0s.append(o.float().cpu()))
    try:
        streams = {k: ss.stream(_slabs(m, slab)) for k, m in enumerate(mels)}
        for k in streams:
            log[k] = []
        while streams:
            for k in list(streams):
                current[0] = k
                if next(streams[k], None) is None:
                    del streams[k]
    finally:
        handle.remove()
        del ss._chunk
    return log, f0s


@pytest.mark.parametrize("dtype", ["", None])
def test_live_graphs_replay_bit_equal_to_eager(card, monkeypatch, dtype):
    """Two sessions interleaved on one warmed synthesizer: every chunk of the
    ramp and the steady state replays a graph, the tail flushes run
    eagerly, and the audio, the carries and the F0 net's outputs (the
    check's hook) equal the eager path's bit for bit."""
    from mbexwn_vocoder_torch.parallel import StreamingSynthesizer

    model = _live_model(monkeypatch, dtype)
    mels = [_mel(16 * 8 + 5, 40), _mel(16 * 8, 41)]  # tails: 5 frames; 16 frames with the lookahead cut
    graphed = StreamingSynthesizer(model, device=card, **LIVE)
    graphed.warm()
    assert len(graphed._graphs) == 3
    got, got_f0 = _interleaved(graphed, mels)
    eager = StreamingSynthesizer(model, device=card, **LIVE)
    want, want_f0 = _interleaved(eager, mels)
    assert eager.replays == 0 and graphed.replays == 8 + 7  # every chunk but the tail
    assert [len(got[k]) for k in got] == [len(want[k]) for k in want] == [9, 8]
    for k in want:
        for (a, c), (wa, wc) in zip(got[k], want[k]):
            assert np.array_equal(a, wa) and np.array_equal(c, wc)
    assert len(got_f0) == len(want_f0) == 17
    assert all(torch.equal(a, b) for a, b in zip(got_f0, want_f0))


def test_a_replayed_chunk_is_one_graph_launch(card, monkeypatch):
    """warm() counts the kernels it runs and captures (one K1 stack a WaveNet
    block and one K2 a chunk program); a replayed chunk counts none and
    makes at most 120 launch calls, one of them the graph's: the rest are
    the eager NormMel's (20) and F0 net's (95) on the shipped bf16 config,
    against ~340 for an eager chunk."""
    from mbexwn_vocoder_torch.parallel import StreamingSynthesizer

    ss = StreamingSynthesizer(_live_model(monkeypatch, None), device=card, **LIVE)
    before = dict(kernel_lib.launches)
    ss.warm()
    runs = 3 * 3  # three ramp shapes: the eager run, the run on the capture stream, the capture
    assert kernel_lib.launches["wavenet_layer"] - before["wavenet_layer"] == 24 * runs
    assert kernel_lib.launches["oscillator"] - before["oscillator"] == runs
    span = torch.from_numpy(_mel(50, 42))
    carry = torch.zeros((1,), dtype=torch.float64, device=card)
    ss._chunk(span, carry, 32, 16)[0].cpu()
    before = dict(kernel_lib.launches)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        ss._chunk(span, carry, 32, 16)[0].cpu()
    assert kernel_lib.launches == before and ss.replays == 2
    names = [e.name for e in prof.events() if LAUNCH_CALL.match(e.name)]
    assert sum("GraphLaunch" in n for n in names) == 1 and len(names) <= 120, names


@pytest.mark.parametrize("B,T", [(3, 12_345), (4, 300_000)])
def test_k2_in_a_cuda_graph_equals_its_eager_launch(card, B, T):
    """K2's cooperative launch captured in a CUDA graph: each replay equals
    the eager launch on the inputs then in its buffers, bit for bit (the
    second shape has more chunks than CTAs resident at once)."""
    g = torch.Generator().manual_seed(B + T)
    tables = torch.randn(513, 13, generator=g).to(card)
    consts = (46.875, 1.25, 1.0, 1.25 ** 12, 12000.0)
    f0 = (40.0 + 560.0 * torch.rand(B, T, generator=g)).to(card)
    offset = (torch.rand(B, generator=g) - 0.5).to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = kernel_lib.launches["oscillator"]
    with torch.cuda.graph(graph, stream=side):
        audio, phase = oscillate(f0, tables, *consts, phase_offset=offset, return_phase=True)
    assert kernel_lib.launches["oscillator"] - before == 1
    for step in range(2):
        if step:
            f0.copy_((40.0 + 560.0 * torch.rand(B, T, generator=g)).to(card))
            offset.copy_((torch.rand(B, generator=g) - 0.5).to(card))
        graph.replay()
        want, want_phase = oscillate(f0, tables, *consts, phase_offset=offset, return_phase=True)
        torch.cuda.synchronize()
        assert torch.equal(audio, want) and torch.equal(phase, want_phase)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def test_kernels_launch_on_a_second_card(two_cards):
    """Both kernels on cuda:0 and then on cuda:1 while cuda:0 stays the
    current device, at the sizes whose per-device state matters: K1 in bf16
    at C = 320 (its dynamic shared memory above 48 KB, an attribute of each
    device) and K2 with a 2049 x 13 table (past 48 KB, and its count of
    resident blocks, taken per device)."""
    torch.cuda.set_device(two_cards[0])
    g = torch.Generator().manual_seed(7)
    tables = torch.randn(2049, 13, generator=g)
    f0 = 40.0 + 560.0 * torch.rand(2, 20_000, generator=g)
    consts = (46.875, 1.25, 1.0, 1.25 ** 12, 12000.0)
    for dev in two_cards:
        x, cond, weights = _case(320, 2, 300, (1, 2, 4), torch.bfloat16, dev)
        before = dict(kernel_lib.launches)
        with exact_fp32():
            got = wavenet_stack(x, cond, weights, (1, 2, 4))
            ref = wavenet_stack_plain(x, cond, weights, (1, 2, 4))
        audio = oscillate(f0.to(dev), tables.to(dev), *consts)
        audio_ref = oscillate_plain(f0.to(dev), tables.to(dev), *consts)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0 and got.device == audio.device == dev
        assert kernel_lib.launches["wavenet_layer"] - before["wavenet_layer"] == 3
        assert kernel_lib.launches["oscillator"] - before["oscillator"] == 1
        rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
        assert torch.isfinite(got).all() and rel <= 2e-2, (dev, rel)
        assert float((audio - audio_ref).abs().max()) <= 1e-5


# ---- training on the card

def test_kernels_refuse_grad(card):
    """Grad mode and an input that requires grad: both kernels raise instead
    of cutting the autograd graph; without grad they run."""
    x, cond, weights = _case(16, 1, 70, (1, 2), torch.float32, card)
    for i, t in enumerate((x, cond, weights[0][0])):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward pass"):
            wavenet_stack(x, cond, weights, (1, 2))
        with torch.no_grad():
            wavenet_stack(x, cond, weights, (1, 2))
        t.requires_grad_(False)
    f0 = torch.full((1, 3000), 140.0, device=card)
    tables = torch.rand((65, 5), device=card)
    consts = (50.0, 1.25, 1.0, 13.0, 12000.0)
    for t in (f0, tables):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward pass"):
            oscillate(f0, tables, *consts)
        with torch.inference_mode():
            oscillate(f0, tables, *consts)
        t.requires_grad_(False)
    torch.cuda.synchronize()


def test_training_step_on_the_card_matches_the_cpu(card):
    """The tiny case of the CPU parity tests (`training.parity`): in fp64
    the card's loss within 1e-12 of the CPU's and every gradient leaf within
    1e-9 rel-RMS; in fp32 the loss within 1e-5."""
    from mbexwn_vocoder_torch.training.parity import card_against_cpu

    failures, numbers = card_against_cpu(card)
    print(numbers)
    assert not failures, failures


def test_trained_model_folds_back_onto_the_kernels(card):
    """After a training step and `fold_()`, the model synthesises on the card
    through K1 (one launch a layer) and K2 (one launch)."""
    from mbexwn_vocoder_torch.models import create_model
    from mbexwn_vocoder_torch.training.parity import tiny_batch, tiny_hparams
    from mbexwn_vocoder_torch.training.trainer import Trainer

    hp = tiny_hparams()
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(0))
    tr = Trainer(model, hp, device=card)
    batch = tiny_batch()
    tr.train_step(batch)
    model.fold_()
    blk = model.block
    n_layers = sum(getattr(blk, name).wavenet.n_layers for name in blk.block_names)
    mel = torch.from_numpy(batch["mel"]).to(card)
    with torch.inference_mode():
        kernel_lib.reset_launch_counts()
        y = model.infer(mel, mel.shape[1] * blk.spect_hop_size)
        counts = dict(kernel_lib.launches)
    n_up = sum(getattr(blk, name).wavenet.cond_upsampling() > 1 for name in blk.block_names)
    assert n_up == 2 and counts == {"wavenet_layer": n_layers, "oscillator": 1, "wavenet_cond_upsampled": n_up,
                                  "post_pqmf": 1}, counts
    assert torch.isfinite(y).all()


# ---- the training CLI and adversarial training on the card

def test_train_cli_on_the_card(card, tmp_path, monkeypatch):
    """Two CLI steps of a tiny config on the card, its default device (the
    JAX package's CLI test settings), finite metrics, and an export that
    MELInverter synthesises on the card through K1 and K2."""
    import json
    import os

    from mbexwn_vocoder_torch.cli.train import main
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.training.synthetic import make_corpus

    monkeypatch.delenv("MBEXWN_PLATFORM", raising=False)
    make_corpus(str(tmp_path / "data"), n_utterances=2, seed=0, duration_range=(1.0, 1.5), quiet=True)
    cargs = ["mbexwn_config:pp_mod_subnet:n_channels=16", "mbexwn_config:pp_mod_subnet:n_layers=2",
             "mbexwn_config:pp_mod_subnet:n_out_channels=8", "mbexwn_config:normalize_rms_from_mell=False",
             "preprocess_config:segment_length=6000"]
    out = str(tmp_path / "run")
    run = main("SPEECH", str(tmp_path / "data"), out, steps=2, batch_size=2, log_every=1, cargs=cargs,
               num_workers=1)
    assert run["device"].startswith("cuda") and run["end_step"] == 2
    recs = [json.loads(line) for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(v) for r in recs for v in r.values())
    inv = MELInverter(out, device=card)
    mel = np.random.RandomState(0).randn(1, 64, 80).astype(np.float32) * 0.5 - 4
    kernel_lib.reset_launch_counts()
    y = inv.synth_from_mel(mel)
    assert dict(kernel_lib.launches) == {"wavenet_layer": 4, "oscillator": 1, "wavenet_cond_upsampled": 2,
                                         "post_pqmf": 1}
    assert np.isfinite(y).all()


def test_gan_step_on_the_card_matches_the_cpu(card):
    """One adversarial step of the tiny case in fp64: the card's metrics
    within 1e-12 of the CPU's, every gradient leaf of the generator and the
    discriminator within 1e-9 rel-RMS (`training.parity.gan_card_against_cpu`)."""
    from mbexwn_vocoder_torch.training.parity import gan_card_against_cpu

    failures, numbers = gan_card_against_cpu(card)
    print(numbers)
    assert not failures, failures


# ---- the kernels as torch.library ops, the AOT export and remat on the card

def test_kernel_ops_launch_or_raise_on_the_card(card):
    """`mbexwn::wavenet_stack` and `mbexwn::oscillate` on CUDA tensors
    launch their kernels (counted inside the ops) or raise; nothing falls
    back to the plain version."""
    x, cond, weights = _case(64, 1, 200, (1, 2), torch.bfloat16, card)
    p = pack_stack_weights(weights)
    w = [p.w_dil, p.b_dil, p.w_rs, p.b_rs]
    before = dict(kernel_lib.launches)
    skip = torch.ops.mbexwn.wavenet_stack(x, cond, *w, [1, 2], list(p.skip_only), "gtu", False)
    audio, phase = torch.ops.mbexwn.oscillate(torch.full((1, 3000), 140.0, device=card),
                                              torch.rand((65, 5), device=card), 50.0, 1.25, 1.0, 13.0, 12000.0,
                                              None, True)
    torch.cuda.synchronize()
    assert kernel_lib.launches["wavenet_layer"] - before["wavenet_layer"] == 2
    assert kernel_lib.launches["oscillator"] - before["oscillator"] == 1
    assert skip.dtype == torch.float32 and skip.shape == (1, 200, 64) and phase.shape == audio.shape
    with pytest.raises(NotImplementedError, match="gtu"):
        torch.ops.mbexwn.wavenet_stack(x, cond, *w, [1, 2], list(p.skip_only), "glu", False)
    with pytest.raises(ValueError, match="kernel layout"):
        torch.ops.mbexwn.wavenet_stack(x, cond, w[0][..., :-1].contiguous(), *w[1:], [1, 2], list(p.skip_only),
                                       "gtu", False)


def test_export_round_trip_on_the_card(card, tmp_path):
    """The tiny model exported for the card and loaded: each call launches
    K1 once a layer and K2 once, and equals the model's own synthesis on
    the card given the same noise draw."""
    from mbexwn_vocoder_torch.compat.export import export_synthesis, load_exported
    from mbexwn_vocoder_torch.models import create_model
    from mbexwn_vocoder_torch.training.parity import tiny_hparams

    hp = tiny_hparams()
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.init(torch.Generator().manual_seed(0))
    model = model.eval().to(card)
    blob = export_synthesis(model, T_mel=16, batch_size=2, platforms=("cuda",))
    call, meta = load_exported(blob, device="cuda")
    mel = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 80).astype(np.float32) * 0.5 - 4).to(card)
    kernel_lib.reset_launch_counts()
    y = call(mel)
    torch.cuda.synchronize()
    assert dict(kernel_lib.launches) == {"wavenet_layer": 4, "oscillator": 1, "wavenet_cond_upsampled": 2,
                                         "post_pqmf": 1}
    noise = torch.randn((2, model.block.wn_input_length(16), 1), generator=torch.Generator(device=card).manual_seed(0),
                        device=card)
    with torch.inference_mode():
        ref = model.infer(mel, synth_length=16 * 300, noise=noise)
    assert meta["platforms"] == ["cuda"] and float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_remat_step_on_the_card_equals_the_step_without(card, monkeypatch):
    """The tiny case in fp64 on the card: with remat_wavenet_blocks the loss
    and every gradient leaf within 1e-12 of the step without."""
    from mbexwn_vocoder_torch.models import create_model
    from mbexwn_vocoder_torch.training.parity import hold_leaves, tiny_batch, tiny_hparams
    from mbexwn_vocoder_torch.training.trainer import Trainer

    monkeypatch.setenv("MBEXWN_WN_DTYPE", "")
    monkeypatch.setenv("MBEXWN_SUBNET_DTYPE", "")
    out = {}
    for remat in (False, True):
        hp = tiny_hparams(**{"mbexwn_config.remat_wavenet_blocks": remat})
        m, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
        m.init(torch.Generator().manual_seed(0))
        tr = Trainer(m.double(), hp, device=card)
        batch = tiny_batch()
        draws = {k: torch.randn(s, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
                 for k, s in tr.draw_shapes(batch).items()}
        loss, _, grads = tr.value_and_grad(batch, 0, draws)
        out[remat] = (float(loss), {k: v.cpu().numpy() for k, v in grads.items()})
    assert abs(out[True][0] / out[False][0] - 1) <= 1e-12
    bad, _ = hold_leaves(out[True][1], out[False][1], 1e-12)
    assert not bad, bad


def _routes_model(card, monkeypatch, tp=False, config=None, **pp_mod):
    """SPEECH at 64 channels and 4 layers (pp_mod_subnet edited, and
    mbexwn_config by `config`), random init seeded, fp32: (the model on the
    CPU, the same on the card)."""
    import copy

    from mbexwn_vocoder_torch.models import create_model
    from mbexwn_vocoder_torch.training.parity import tiny_hparams

    monkeypatch.setenv("MBEXWN_WN_DTYPE", "")
    monkeypatch.setenv("MBEXWN_SUBNET_DTYPE", "")
    if tp:
        monkeypatch.setenv("MBEXWN_TP_AXIS", "model")
    hp = tiny_hparams()
    hp["mbexwn_config"]["pp_mod_subnet"].update(n_channels=64, n_layers=4, **pp_mod)
    hp["mbexwn_config"].update(config or {})
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    model.init(torch.Generator().manual_seed(0))
    model = model.eval()
    return model, copy.deepcopy(model).to(card)


def _synth_both(model_cpu, model, card, T_mel=32, B=2):
    mel = torch.from_numpy(np.random.RandomState(1).randn(B, T_mel, 80).astype(np.float32) * 0.5 - 4)
    noise = torch.from_numpy(np.random.RandomState(2).randn(B, model.block.wn_input_length(T_mel), 1)
                             .astype(np.float32))
    with torch.inference_mode():
        ref = model_cpu.infer(mel, synth_length=T_mel * 300, noise=noise)
        kernel_lib.reset_launch_counts()
        got = model.infer(mel.to(card), synth_length=T_mel * 300, noise=noise.to(card))
        torch.cuda.synchronize()
    return got.cpu(), ref, dict(kernel_lib.launches)


@pytest.mark.parametrize("pp_mod", [dict(activation="glu"), dict(activation="gfu"), dict(activation="gsu"),
                                    dict(n_ch_groups=2), dict(kernel_size=5)], ids=str)
def test_branches_synthesise_on_the_card(card, monkeypatch, pp_mod):
    """A stack the kernel does not take (before the port of the branches a
    non-gtu gate raised here) runs the layer loop on the card: equal to the
    CPU within 1e-5 rel-RMS in fp32, with no K1 launch."""
    model_cpu, model = _routes_model(card, monkeypatch, **pp_mod)
    got, ref, counts = _synth_both(model_cpu, model, card)
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    assert counts == {"wavenet_layer": 0, "oscillator": 1, "wavenet_cond_upsampled": 0,
                      "post_pqmf": 1} and rel <= 1e-5, (counts, rel)


def test_tensor_parallel_on_the_card(card, monkeypatch):
    """MBEXWN_TP_AXIS=model over a 1 x 2 mesh of the one card: equal to the
    same model unsharded within 1e-5 in fp32, no K1 launch, one reduce a
    layer through torch.cuda.comm."""
    from mbexwn_vocoder_torch.parallel import tensor
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh, replicate

    model_cpu, model = _routes_model(card, monkeypatch, tp=True)
    got_plain, _, _ = _synth_both(model_cpu, model, card)
    replica = replicate(model, make_mesh(n_model=2, devices=["cuda:0", "cuda:0"]))[torch.device("cuda", 0)]
    calls = []
    real = tensor.comm.reduce_add
    monkeypatch.setattr(tensor.comm, "reduce_add", lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _, counts = _synth_both(model_cpu, replica, card)
    rel = float(torch.sqrt(torch.mean((got - got_plain) ** 2) / torch.mean(got_plain ** 2)))
    assert counts == {"wavenet_layer": 0, "oscillator": 1, "wavenet_cond_upsampled": 0, "post_pqmf": 1}, counts
    assert len(calls) == 2 * 4 and rel <= 1e-5, rel
    assert all(getattr(replica.block, n).wavenet.tp_devices == (torch.device("cuda", 0),) * 2
               for n in replica.block.block_names)


@pytest.mark.parametrize("C", [320, 340])
def test_int8_products_on_the_card(card, C):
    """torch._int_mm at the registry widths, padded where C=340 needs it,
    equals the integer product on the CPU exactly; a card int8 conv equals
    the CPU's within 1e-6 (only the fp32 dequantization may round apart)."""
    from mbexwn_vocoder_torch.ops.quant import dilated_conv1d_k3_int8, int8_matmul

    g = torch.Generator().manual_seed(C)
    for K, N, M in ((3 * C, 2 * C, 5), (C, C, 300)):
        xq = torch.randint(-127, 128, (2, M, K), generator=g, dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
        assert torch.equal(int8_matmul(xq.to(card), wq.to(card)).cpu(), (xq.long() @ wq.long().t()).int())
    x = torch.randn(2, 400, C, generator=g)
    w = torch.randn(2 * C, C, 3, generator=g) * 0.05
    got = dilated_conv1d_k3_int8(x.to(card), w.to(card), None, 4).cpu()
    ref = dilated_conv1d_k3_int8(x, w, None, 4)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_int8_mode_on_the_card(card, monkeypatch):
    """MBEXWN_WN_QUANT=int8: the card's synthesis equals the CPU's int8
    within 2e-2 (the int32 products are exact; a value within rounding of
    a round-half tie, or of its sample's abs-max, may fall into the next
    bin: 2.3e-3 measured in fp32 on an H100), runs 2 products a layer and no K1
    launch, and differs from the fp32 synthesis."""
    from mbexwn_vocoder_torch.ops import quant

    model_cpu, model = _routes_model(card, monkeypatch)
    got_fp, _, counts_fp = _synth_both(model_cpu, model, card)
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    before = quant.int_mm_calls
    got, ref, counts = _synth_both(model_cpu, model, card)
    assert counts_fp == {"wavenet_layer": 8, "oscillator": 1, "wavenet_cond_upsampled": 2, "post_pqmf": 1}
    assert counts == {"wavenet_layer": 0, "oscillator": 1, "wavenet_cond_upsampled": 0, "post_pqmf": 1}
    assert quant.int_mm_calls - before == 2 * (2 * 2 * 4)  # the CPU's and the card's synthesis
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    rel_fp = float(torch.sqrt(torch.mean((got - got_fp) ** 2) / torch.mean(got_fp ** 2)))
    assert rel <= 2e-2 and rel_fp > 1e-3, (rel, rel_fp)


_WAVETABLE = dict(nominalF0=50.0, maxF0=650.0, F0GridFactor=1.25, wt_oversampling=2, Oq=0.5, am=0.8, rta=0.05)


@pytest.mark.parametrize("config,pp_mod,k2", [
    (dict(wavetable_config=dict(_WAVETABLE, use_sinusoid_as_fun=True)), {}, 0),
    (dict(wavetable_config=dict(_WAVETABLE, add_subharm_chans=2)), {}, 1),
    (dict(pulse_channels_use_pqmf=True, pulse_channels_multi_band_config=dict(subbands=6, taps=94,
                                                                               cutoff_ratio=0.0945, beta=9.0)), {}, 1),
    (dict(ps_use_stft=False, spect_filters_preserve_energy=True), {}, 1),
    ({}, dict(use_weight_norm=False, use_equalized_lr=True), 1),
], ids=["sinusoid_as_fun", "subharmonics", "pulse_pqmf", "multiband_gain", "equalized_lr_post_gain"])
def test_model_branches_on_the_kernels(card, monkeypatch, config, pp_mod, k2):
    """The model's opt-in branches on the card: equal to the CPU within 1e-4
    rel-RMS in fp32, with K1 on both stacks (4 + 4 launches) and K2 once,
    or not at all for the analytic pulse, which computes from the phase."""
    model_cpu, model = _routes_model(card, monkeypatch, config=config, **pp_mod)
    got, ref, counts = _synth_both(model_cpu, model, card)
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    assert counts == {"wavenet_layer": 8, "oscillator": k2, "wavenet_cond_upsampled": 2,
                      "post_pqmf": 1} and rel <= 1e-4, (counts, rel)


def test_int8_under_tensor_parallelism_on_the_card(card, monkeypatch):
    """MBEXWN_WN_QUANT=int8 with MBEXWN_TP_AXIS=model over cuda:0 twice: four
    int8 products a layer (two a shard), one max-reduce and one sum-reduce
    a layer, no K1 launch, within 2e-2 of the unsharded int8 synthesis."""
    from mbexwn_vocoder_torch.ops import quant
    from mbexwn_vocoder_torch.parallel import tensor
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh, replicate

    model_cpu, model = _routes_model(card, monkeypatch, tp=True)
    monkeypatch.setenv("MBEXWN_WN_QUANT", "int8")
    got_plain, _, _ = _synth_both(model_cpu, model, card)
    replica = replicate(model, make_mesh(n_model=2, devices=["cuda:0", "cuda:0"]))[torch.device("cuda", 0)]
    n_mm, before = quant.int_mm_calls, dict(tensor.counts)
    got, _, counts = _synth_both(model_cpu, replica, card)
    assert quant.int_mm_calls - n_mm == 2 * 4 * 2 + 2 * 4 * 4  # the CPU's unsharded, the card's sharded
    assert {k: tensor.counts[k] - before[k] for k in before} == {"reduce_add": 8, "max_reduce": 8}
    rel = float(torch.sqrt(torch.mean((got - got_plain) ** 2) / torch.mean(got_plain ** 2)))
    assert counts == {"wavenet_layer": 0, "oscillator": 1, "wavenet_cond_upsampled": 0,
                      "post_pqmf": 1} and rel <= 2e-2, (counts, rel)


WAVEGLOW_DILS = (1, 2, 4, 8, 16, 32, 64, 128)


def _per_layer_case(C, B, T, dils, dtype, device, seed=0):
    x, _, weights = _case(C, B, T, dils, dtype, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    cond = (torch.randn(B, T, len(dils), 2 * C, generator=g) * 0.2).to(device, dtype)
    return x, cond, weights


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B", [1, 8])
def test_k1_per_layer_cond_at_waveglow_shapes(card, B, dtype, tol):
    """A WaveGlow WN's stack (C=256, 8 layers) on a 1024-frame bucket: 32,768
    rows an utterance, a cond slab a layer read in place."""
    x, cond, weights = _per_layer_case(256, B, 32768, WAVEGLOW_DILS, dtype, card)
    before = kernel_lib.launches["wavenet_layer"]
    with exact_fp32():
        got = wavenet_stack(x, cond, weights, WAVEGLOW_DILS)
        ref = wavenet_stack_plain(x, cond, weights, WAVEGLOW_DILS)
    torch.cuda.synchronize()
    assert kernel_lib.launches["wavenet_layer"] - before == 8
    rel = float(torch.sqrt(torch.mean((got - ref) ** 2) / torch.mean(ref ** 2)))
    assert torch.isfinite(got).all() and rel <= tol, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,dils", [(256, 1000, WAVEGLOW_DILS), (320, 391, (1, 64, 16, 4)),
                                      (340, 257, (32, 2, 64))])
def test_k1_equal_slabs_equal_the_shared_cond(card, C, T, dils, dtype):
    x, cond, weights = _per_layer_case(C, 2, T, dils, dtype, card, seed=5)
    shared = cond[:, :, 0].contiguous()
    same = shared[:, :, None].expand_as(cond).contiguous()
    assert torch.equal(wavenet_stack(x, same, weights, dils), wavenet_stack(x, shared, weights, dils))


def test_waveglow_on_the_card(card, tmp_path, monkeypatch):
    """The published widths (12 flows x 8-layer WN at C=256), seeded weights:
    every WN on K1, 96 launches a synthesis; fp32 within 1e-4 of the plain
    reference on the card."""
    import chip_smoke
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from tests.waveglow_reference import Reference, write_model_dir

    config = chip_smoke.waveglow_config()
    path = write_model_dir(config, tmp_path / "waveglow")
    mel = chip_smoke.make_mel(40, 80, 5)
    ref = Reference(config, path, card).synth(torch.from_numpy(mel).to(card)).cpu().numpy()[0]
    monkeypatch.setenv("MBEXWN_WN_DTYPE", "")
    inv = MELInverter(str(path), device=card, length_buckets=(40,))
    kernel_lib.reset_launch_counts()
    y = inv.synth_from_mel(mel)
    assert [wn.route() for wn in inv.model.WN] == ["k1"] * 12
    assert kernel_lib.launches["wavenet_layer"] == 96 and kernel_lib.launches["wavenet_cond_upsampled"] == 0
    assert kernel_lib.launches["post_pqmf"] == 0  # no PQMF: K3 never runs
    rel = float(np.sqrt(np.mean((y - ref) ** 2) / np.mean(ref ** 2)))
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("frames", [1024, 37])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [256, 320, 340])
def test_k1_frame_rate_cond_equals_the_upsampled_slab(card, C, dtype, causal, frames):
    """K1 on a shared cond at the frame rate with U = 25, (8, frames + 1, 2C)
    with the last frame repeated, against K1 on `linear_interp_upsample`'s
    full-rate slab (U = 1): bit for bit, one stack call counted as upsampled."""
    U, B, dils = 25, 8, (1, 64, 16)
    x, _, weights = _case(C, B, frames * U, dils, dtype, card)
    g = torch.Generator().manual_seed(9)
    low = pad_end((torch.randn(B, frames, 2 * C, generator=g) * 0.2).to(card, dtype), 1)
    before = dict(kernel_lib.launches)
    with exact_fp32():
        got = wavenet_stack(x, low, weights, dils, causal=causal, cond_upsampling=U)
        ref = wavenet_stack(x, linear_interp_upsample(low, U, drop_last=True), weights, dils, causal=causal)
    torch.cuda.synchronize()
    assert kernel_lib.launches["wavenet_layer"] - before["wavenet_layer"] == 2 * len(dils)
    assert kernel_lib.launches["wavenet_cond_upsampled"] - before["wavenet_cond_upsampled"] == 1
    assert torch.isfinite(got).all() and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["", None])
def test_speech_synthesis_interpolates_its_conds_in_k1(card, monkeypatch, dtype):
    """A SPEECH synthesis (fp32, and the shipped bf16) hands K1 both blocks'
    conds at the frame rate (the counter reads 2) and gives the audio of the
    same synthesis with the interpolation outside K1 (the full-rate slab,
    U = 1) bit for bit."""
    from mbexwn_vocoder_torch.mel_inverter import MELInverter

    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        if dtype is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, dtype)
    inv = MELInverter("SPEECH")
    mel = _mel(300, 31)
    noise = _noise_rows(inv, [300], card)[0]
    kernel_lib.reset_launch_counts()
    y = inv.synth_from_mel(mel, noise=noise)
    assert kernel_lib.launches["wavenet_cond_upsampled"] == 2 and kernel_lib.launches["wavenet_layer"] == 24
    monkeypatch.setattr(WaveNetAE, "cond_upsampling", lambda self: 1)
    kernel_lib.reset_launch_counts()
    y_slab = inv.synth_from_mel(mel, noise=noise)
    assert kernel_lib.launches["wavenet_cond_upsampled"] == 0 and kernel_lib.launches["wavenet_layer"] == 24
    assert np.isfinite(y).all() and np.array_equal(y, y_slab)


def test_a_speech_synthesis_launches_k3_once(card, monkeypatch):
    """The shipped SPEECH synthesis runs its post net and PQMF synthesis as
    one K3 launch (`kernel_lib.launches["post_pqmf"]` reads 1), and its
    audio is within 1e-5 rel-RMS of the same synthesis with the stage's
    plain version (fp32 sums in another order, through the envelope's
    STFT filter)."""
    from mbexwn_vocoder_torch.mel_inverter import MELInverter
    from mbexwn_vocoder_torch.models import mbexwn

    for var in ("MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    inv = MELInverter("SPEECH")
    mel = _mel(300, 32)
    noise = _noise_rows(inv, [300], card)[0]
    kernel_lib.reset_launch_counts()
    y = inv.synth_from_mel(mel, noise=noise)
    assert kernel_lib.launches["post_pqmf"] == 1
    monkeypatch.setattr(mbexwn, "post_pqmf", post_pqmf_plain)
    kernel_lib.reset_launch_counts()
    y_plain = inv.synth_from_mel(mel, noise=noise)
    assert kernel_lib.launches["post_pqmf"] == 0
    assert np.isfinite(y).all() and _rel(y, y_plain) <= 1e-5, _rel(y, y_plain)


def test_the_training_route_never_launches_k3(card):
    """A model on the training route (`differentiable`) runs the post net and
    the PQMF synthesis in plain PyTorch with grad on and off: a training step
    and a no_grad forward of the generator, as the adversarial trainer's
    discriminator step runs it, launch no K3, as they launch no K1 or K2."""
    from mbexwn_vocoder_torch.models import create_model
    from mbexwn_vocoder_torch.training.parity import tiny_batch, tiny_hparams
    from mbexwn_vocoder_torch.training.trainer import Trainer

    hp = tiny_hparams()
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(0))
    tr = Trainer(model, hp, device=card)
    batch = tiny_batch()
    kernel_lib.reset_launch_counts()
    tr.train_step(batch)
    b = tr._batch(batch)
    with torch.no_grad():
        signal, _, _ = tr.training_forward(b["audio"], b["mel"], b["F0"], 0, F0_ds=b["F0_ds"])
    torch.cuda.synchronize()
    assert model.block.differentiable and torch.isfinite(signal).all()
    assert dict(kernel_lib.launches) == {"wavenet_layer": 0, "oscillator": 0, "wavenet_cond_upsampled": 0,
                                         "post_pqmf": 0}
