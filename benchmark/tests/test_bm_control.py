"""The control comes out not correct: the program's int8 mode (the WaveNet
one precision below bf16) and the reference in fp8 put in the program's
place, each driven through a whole run of the cell at a small size."""
import pytest

from conftest import run_cell


@pytest.mark.parametrize("control", ["int8", "ref8"])
def test_offline_control_fails(control):
    r = run_cell("speech-offline", extra=("--control", control))
    assert r["correct"] is False
    assert r["checks"]["hf_lsd_db"]["value"] > r["checks"]["hf_lsd_db"]["limit"]


def test_live_control_fails():
    r = run_cell("speech-live", extra=("--control", "ref8"))
    assert r["correct"] is False


def test_sound_run_is_correct():
    r = run_cell("speech-offline", seconds=6.0)
    assert r["correct"] is True and r["failed"] == 0 and r["metrics"]["audio_s_per_s"]["value"] > 0
