"""The numbers that decide `correct`, and their limits.

Each compared answer (an utterance, or a live session's chunks joined) is
held to the reference three ways (benchmark/reference/mbexwn_ref.py says
why the F0 stage is held on its own and the synthesis from the program's
F0):
- `f0_rel`: rel-RMS of the program's F0 contour against the reference's
  F0 net on the same mel;
- `audio_rel`: rel-RMS of the waveform against the reference's synthesis
  from that F0, with the same noise and phase offsets;
- `hf_lsd_db`: the log-spectral distance above 6 kHz (dB, the RMS over
  bins of each STFT frame's dB difference, bins floored at -80 dB of the
  reference's peak, averaged over frames), where the WaveNet's rounding
  noise stands out against speech's falling spectrum;
and `missing`: answers due in the window that never came (limit 0).
A run's number is its worst answer's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

NUMBERS = ("f0_rel", "audio_rel", "hf_lsd_db", "missing")
WRONG = 1e30  # the reading of an answer that gives no finite number


def rel_rms(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))


def hf_lsd_db(y, ref, sample_rate: int, f_lo: float = 6000.0, n_fft: int = 1024, hop: int = 256) -> float:
    def mag(a):
        t = torch.from_numpy(np.asarray(a, np.float32).ravel())
        return torch.stft(t, n_fft, hop, window=torch.hann_window(n_fft), return_complex=True).abs().numpy()

    P, R = mag(y), mag(ref)
    lo = int(np.ceil(f_lo / (sample_rate / n_fft)))
    floor = max(float(R.max()), 1e-30) * 1e-4
    d = 20 * np.log10(np.maximum(P[lo:], floor)) - 20 * np.log10(np.maximum(R[lo:], floor))
    return float(np.mean(np.sqrt(np.mean(d ** 2, axis=0))))


def limits_for(workload: str, root: Path) -> Dict[str, float]:
    return json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())["limits"]


class Tally:
    """The worst reading of each number over a run's compared answers."""

    def __init__(self, sample_rate: int):
        self.sr = sample_rate
        self.worst = {"f0_rel": 0.0, "audio_rel": 0.0, "hf_lsd_db": 0.0, "missing": 0}
        self.n = 0

    def add(self, f0_prog, f0_ref, audio_prog, audio_ref) -> None:
        self.n += 1
        vals = {"f0_rel": rel_rms(f0_prog, f0_ref), "audio_rel": rel_rms(audio_prog, audio_ref),
                "hf_lsd_db": hf_lsd_db(audio_prog, audio_ref, self.sr)}
        for k, v in vals.items():
            if not np.isfinite(v):
                v = WRONG
            self.worst[k] = max(self.worst[k], v)

    def mark_wrong(self) -> None:
        """An answer that cannot be compared (missing pieces, wrong shapes) is wrong."""
        self.n += 1
        for k in ("f0_rel", "audio_rel", "hf_lsd_db"):
            self.worst[k] = WRONG

    def verdict(self, limits: Dict[str, float]) -> (bool, Dict[str, Dict[str, float]]):
        """(correct, {name: {"value", "limit"}}); nothing compared is not correct."""
        out = {k: {"value": self.worst[k], "limit": limits[k]} for k in NUMBERS}
        ok = self.n > 0 and all(out[k]["value"] <= out[k]["limit"] for k in NUMBERS)
        return ok, out


def print_checks(checks: Dict[str, Dict[str, float]], n_compared: int, stream) -> None:
    print(f"compared answers: {n_compared}", file=stream)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=stream)


