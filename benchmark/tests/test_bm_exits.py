"""A run that cannot measure the program prints no result and exits non-zero."""
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "speech-offline", "--seed", "1",
                           "--seconds", "1", "--trace", "0", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "not beside the benchmark" in r.stderr


def test_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run(ROOT)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "no CUDA device" in r.stderr


@pytest.mark.cuda
def test_one_short_run_on_the_card(cuda_device):
    r = run(ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    import json

    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
