"""Shared helpers of the benchmark's CPU tests."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (ROOT, BENCH, BENCH / "metrics"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# tiny versions of each cell's mix, for whole runs on the CPU
TINY = {
    "speech-offline": {"frames": [100, 120], "bucket": 128, "pool": 8, "batch": 2, "depth": 2, "check_groups": 1,
                       "check_group_range": [0, 2], "lead_s": 0.1},
    "speech-live": {"sessions": 2, "utterance_s": 3.0, "check_sessions": 1, "lead_s": 0.2},
}


def run_cell(workload, seed=2147483999, seconds=2.0, extra=(), override=None):
    """One whole run of a cell on the CPU at a tiny size -> its result dict."""
    import harness

    return harness.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--device", "cpu",
                         *extra], mix_override={**TINY[workload], **(override or {})})


@pytest.fixture
def cuda_device():
    """The card, for the tests marked `cuda`; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
