"""The frozen counts: the synthesis FLOP count and K1's share of it."""
import json

import pytest

import counts
from conftest import BENCH


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_speech_512_frames():
    total = counts.synthesis_flops(config("speech"), 512)["flops_per_call"]
    assert round(total / 1e9, 2) == 757.80
    assert round(100 * counts.k1_flops_per_synthesis(config("speech"), 512) / total, 1) == 98.6


def test_batch_scales_and_voice_is_wider():
    s = counts.synthesis_flops(config("speech"), 1024)["flops_per_call"]
    assert counts.synthesis_flops(config("speech"), 1024, batch=8)["flops_per_call"] == 8 * s
    assert counts.synthesis_flops(config("voice"), 1024)["flops_per_call"] > s


def test_k1_work_and_roofline():
    flop, nbytes = counts.k1_work(1, 25600, 320, 12)
    assert flop == 25600 * 320 * 320 * (16 * 11 + 14)
    assert counts.roofline_seconds(flop, nbytes) == pytest.approx(flop / counts.PEAK_BF16_FLOPS)
    assert counts.roofline_seconds(0.0, counts.k2_bytes(8, 153600, 513, 13)) == pytest.approx(
        (8 * 8 * 153600 + 4 * 513 * 13) / counts.PEAK_HBM_BYTES)
