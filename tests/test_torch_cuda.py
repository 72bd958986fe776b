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
and one launch per call.  Serving (SPEECH's registry weights, full width):
the pipeline at batch 1 bit-equal to the blocking loop, a group's dispatch
free of host-device synchronisation, a batch of 8 against single requests
handed the same noise rows, and BatchSynthesizer at B = 8 in the 2048
bucket against the plain K1 path (the largest shapes the kernels see).
Streaming: K1's causal taps against the plain version (ragged batches, both
host entries), and synth_batched and stream() of a full-width causal SPEECH
on the card against the same with K1 replaced by its plain version and
against the CPU.  Training: both kernels raise on CUDA inputs that require
grad (they have no backward pass), one step of the trainer's
differentiable route on the card equals the CPU's (`training.parity` gives
the rule), and a trained model, folded, synthesises through both kernels.
The training CLI: two steps (`cli.train`) on the card with a
tiny config, whose export synthesises through both kernels; one adversarial
step on the card equals the CPU's.  Two cards (skipped with fewer): both
kernels launch on cuda:1 after cuda:0, under the tensors' device.  The
kernels as `torch.library` ops launch or raise on CUDA tensors; a tiny
model's exported program on the card launches both and equals the model's
synthesis; the fp64 remat step on the card equals the step without.
"""
import numpy as np
import pytest
import torch

from mbexwn_vocoder_torch.ops import kernel_lib
from mbexwn_vocoder_torch.ops.oscillator import oscillate, oscillate_plain
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
    assert counts == {"wavenet_layer": n_layers, "oscillator": 1}, counts
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
    assert dict(kernel_lib.launches) == {"wavenet_layer": 4, "oscillator": 1} and np.isfinite(y).all()


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
    assert dict(kernel_lib.launches) == {"wavenet_layer": 4, "oscillator": 1}
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
