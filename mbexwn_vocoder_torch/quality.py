"""The quality gate's metrics and round trip: analyse held-out audio, serve
the mels, re-analyse the synthesis (host NumPy around the synthesis).

The metrics are those of the JAX package's tools/quality_eval.py, per file:
- mel_L1_dB: mean |log-mel| error in dB of the synthesis' own analysis
  against the input mel (the `-v` report of resynth_mel);
- mcd_dB: mel-cepstral distortion, coefficients 1..24 of the orthonormal
  DCT-II of the log-mel frames, (10 sqrt(2) / ln 10) ||dc||_2 per frame,
  mean over frames;
- f0_rmse_hz / voicing_err_pct: YIN contours (dsp/f0.py) of original and
  synthesis at the 80 Hz frame rate: RMSE over the frames both call voiced,
  and the share of frames whose voicing decisions differ.

The held-out v2 corpora are made by `training.synthetic.make_corpus` with
the seeds of `V2_EVAL_SETS`, 8 utterances each.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.fft import dct

from .dsp.db import log_to_db
from .dsp.f0 import estimate_f0
from .serving import PipelinedSynthesizer

# model id -> (corpus name, seed, style) of its held-out v2 eval set
V2_EVAL_SETS = {
    "SPEECH": ("synth_eval_v2", 1099, "speech"),
    "SING": ("sing_eval_v2", 1098, "singing"),
    "VOICE": ("voice_eval_v2", 1097, "mixed"),
}
N_EVAL_UTTERANCES = 8


def mel_l1_db(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Mean absolute log-mel difference in dB."""
    return float(log_to_db * np.mean(np.abs(np.asarray(mel_a) - np.asarray(mel_b))))


def mcd_db(mel_a: np.ndarray, mel_b: np.ndarray) -> float:
    """Mel-cepstral distortion (dB) between aligned (T, n_mels) log-mel frame sets."""
    c_a = dct(np.asarray(mel_a), type=2, norm="ortho", axis=-1)[..., 1:25]
    c_b = dct(np.asarray(mel_b), type=2, norm="ortho", axis=-1)[..., 1:25]
    per_frame = np.sqrt(np.sum((c_a - c_b) ** 2, axis=-1))
    return float((10.0 * np.sqrt(2.0) / np.log(10.0)) * np.mean(per_frame))


def f0_errors(f0_orig: np.ndarray, f0_syn: np.ndarray) -> Tuple[float, float]:
    """(RMSE in Hz over frames voiced in both, voicing mismatch in %) of two
    frame-aligned F0 contours (0 = unvoiced); nan where undefined."""
    n = min(f0_orig.shape[-1], f0_syn.shape[-1])
    f_o, f_s = f0_orig[:n], f0_syn[:n]
    v_o, v_s = f_o > 0, f_s > 0
    both = v_o & v_s
    rmse = float(np.sqrt(np.mean((f_o[both] - f_s[both]) ** 2))) if both.any() else float("nan")
    verr = float(np.mean(v_o != v_s) * 100.0) if n else float("nan")
    return rmse, verr


def f0_metrics(orig: np.ndarray, syn: np.ndarray, sr: int, fmin: float, fmax: float) -> Tuple[float, float]:
    """F0-RMSE and voicing error of two signals at the model's 80 Hz frame rate."""
    hop = max(1, int(round(sr / 80.0)))
    f_o = estimate_f0(orig, sr, hop, fmin=max(fmin, 40.0), fmax=fmax)
    f_s = estimate_f0(np.asarray(syn, dtype=np.float64), sr, hop, fmin=max(fmin, 40.0), fmax=fmax)
    return f0_errors(f_o, f_s)


def _rounded(x: float, digits: int) -> Optional[float]:
    return round(x, digits) if np.isfinite(x) else None


def round_trip(inv, sounds: Sequence[Tuple[str, np.ndarray, int]], depth: int = 3,
               batch: int = 1) -> List[Dict]:
    """Per-file quality rows of (name, samples, sample rate) sounds: analysis
    (`inv.generate_mel_from_snd`), `inv.scale_mel`, synthesis through a
    PipelinedSynthesizer of `depth` and `batch` on `inv`'s device, and
    re-analysis of the synthesis.  batch=1 gives the blocking loop's audio,
    bit for bit."""
    blk = inv.model.block
    fmin, fmax = float(blk.pp_min_frequency or 50.0), float(blk.pp_max_frequency or 600.0)
    mels = [inv.scale_mel(inv.generate_mel_from_snd(snd, srate=sr)) for _, snd, sr in sounds]
    ps = PipelinedSynthesizer(inv.model, length_buckets=inv.length_buckets, depth=depth, batch=batch,
                              device=inv.device)
    rows = []
    for (name, snd, sr), log_mel, syn in zip(sounds, mels, ps.stream(mels)):
        mel_resyn = inv.generate_mel_from_snd(syn, srate=inv.srate)["mell"].T[np.newaxis]
        T = min(log_mel.shape[1], mel_resyn.shape[1])
        n_cmp = min(snd.shape[-1], syn.shape[-1])
        f0_rmse, voicing_err = f0_metrics(snd[..., :n_cmp].reshape(-1), syn[:n_cmp], sr, fmin, fmax)
        rows.append({"file": name, "mel_L1_dB": round(mel_l1_db(log_mel[:, :T], mel_resyn[:, :T]), 3),
                     "mcd_dB": round(mcd_db(log_mel[0, :T], mel_resyn[0, :T]), 3),
                     "f0_rmse_hz": _rounded(f0_rmse, 2), "voicing_err_pct": _rounded(voicing_err, 2),
                     "dur_s": round(snd.shape[-1] / sr, 2)})
    return rows


def summarize(rows: Sequence[Dict]) -> Dict:
    """The report's means over files (f0 and voicing over the files that have one)."""
    def mean(key, digits):
        vals = [r[key] for r in rows if r[key] is not None]
        return round(float(np.mean(vals)), digits) if vals else None

    return {"n_files": len(rows), "mean_mel_L1_dB": mean("mel_L1_dB", 3), "mean_mcd_dB": mean("mcd_dB", 3),
            "mean_f0_rmse_hz": mean("f0_rmse_hz", 2), "mean_voicing_err_pct": mean("voicing_err_pct", 2)}
