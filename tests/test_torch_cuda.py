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
and one launch per call.
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
