"""Synthetic voice-like corpus generator: the eval corpora of the quality
gate.  Copy of the JAX package's training/synthetic.py (pure NumPy/SciPy,
deterministic per seed, bit-equal to it): LF-style glottal pulse trains with
natural F0 contours, time-varying formant resonators, fricative noise
segments and syllabic amplitude modulation, the source-filter structure
MBExWN models.  The held-out v2 sets are `make_corpus` with seeds 1099
(speech), 1098 (singing) and 1097 (mixed), 8 utterances each.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import scipy.signal as ss


def _smooth_contour(rng, n: int, sr_ctrl: float, lo: float, hi: float, tau_s: float) -> np.ndarray:
    """Random contour in [lo, hi]: filtered gaussian walk at control rate."""
    steps = rng.randn(n)
    b, a = ss.butter(2, min(0.99, 1.0 / (tau_s * sr_ctrl)))
    walk = ss.lfilter(b, a, steps)
    walk = (walk - walk.mean()) / (walk.std() + 1e-9)
    mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)
    return mid + half * np.tanh(0.8 * walk)


def _segment_plan(rng, duration_s: float) -> list:
    """Phoneme-like segments: (kind, dur_s), kind in voiced/fricative/pause."""
    plan = []
    t = 0.0
    while t < duration_s:
        r = rng.rand()
        if r < 0.62:
            kind, dur = "voiced", rng.uniform(0.12, 0.45)
        elif r < 0.85:
            kind, dur = "fricative", rng.uniform(0.05, 0.18)
        else:
            kind, dur = "pause", rng.uniform(0.04, 0.25)
        plan.append((kind, dur))
        t += dur
    return plan


def _formant_filter(rng, x: np.ndarray, sr: int, n_blocks: int,
                    formant_scale: float = 1.0) -> np.ndarray:
    """Cascade of 4 slowly-drifting resonators applied block-wise with
    overlap-add crossfades (piecewise-stationary vocal tract).
    formant_scale shifts all resonator ranges (a shorter/longer vocal
    tract) -- used by the distribution-shifted eval variant."""
    ranges = [(int(lo * formant_scale), int(hi * formant_scale))
              for lo, hi in [(280, 900), (900, 2400), (2300, 3400), (3300, 4600)]]
    bws = [(60, 140), (80, 180), (120, 250), (150, 300)]
    n = x.size
    block = int(np.ceil(n / n_blocks))
    fade = np.minimum(block // 4, 256)
    out = np.zeros(n + block)
    targets = [
        (
            _smooth_contour(rng, n_blocks, 1.0, lo, hi, 2.5),
            _smooth_contour(rng, n_blocks, 1.0, blo, bhi, 3.0),
        )
        for (lo, hi), (blo, bhi) in zip(ranges, bws)
    ]
    win = np.ones(block + fade)
    win[:fade] = np.linspace(0, 1, fade)
    win[-fade:] = np.linspace(1, 0, fade)
    for ib in range(n_blocks):
        s0 = ib * block
        seg = x[max(0, s0 - fade // 2) : s0 + block + fade // 2]
        if seg.size == 0:
            break
        y = seg
        for (fc, bw) in targets:
            r = np.exp(-np.pi * bw[ib] / sr)
            th = 2 * np.pi * fc[ib] / sr
            a = [1.0, -2 * r * np.cos(th), r * r]
            y = ss.lfilter([1 - r], a, y)
        w = win[: y.size]
        out[s0 : s0 + y.size] += y * w
    return out[:n]


def _singing_f0(rng, n: int, sr: int, f0_base: float) -> np.ndarray:
    """Sung melody contour: quantized note pitches with portamento + vibrato.

    Notes step over a pentatonic-ish interval set around f0_base, transitions
    glide over ~70 ms, and each note carries 5-6.5 Hz vibrato that ramps in
    after the onset — the F0 statistics the reference's singing models (MW-SI)
    are trained for, vs speech prosody."""
    semis = np.array([-5, -3, 0, 2, 4, 7, 9])
    t0, cur = 0, 0.0
    contour = np.zeros(n)
    while t0 < n:
        dur = int(rng.uniform(0.35, 1.1) * sr)
        cur = float(semis[rng.randint(len(semis))]) + rng.choice([0.0, 12.0], p=[0.85, 0.15])
        contour[t0 : t0 + dur] = cur
        t0 += dur
    glide = int(0.07 * sr)
    kern = np.hanning(2 * glide + 1)
    contour = ss.fftconvolve(contour, kern / kern.sum(), mode="same")
    f0 = f0_base * 2.0 ** (contour / 12.0)

    vib_rate = rng.uniform(5.0, 6.5)
    vib_cents = rng.uniform(25.0, 70.0)
    # vibrato depth follows note stability: deep where the contour is flat
    dc = np.abs(np.gradient(contour)) * sr
    depth = np.clip(1.0 - dc / 4.0, 0.0, 1.0)
    vib_phase = 2 * np.pi * vib_rate * np.arange(n) / sr + rng.uniform(0, 2 * np.pi)
    f0 = f0 * 2.0 ** (depth * (vib_cents / 1200.0) * np.sin(vib_phase))
    f0 *= 1.0 + 0.0015 * rng.randn(n)  # reduced jitter vs speech
    return np.clip(f0, 45.0, 580.0)


def _singing_plan(rng, duration_s: float) -> list:
    """Sung phrasing: long voiced notes, sparse consonant noise, breath pauses."""
    plan = []
    t = 0.0
    while t < duration_s:
        r = rng.rand()
        if r < 0.80:
            kind, dur = "voiced", rng.uniform(0.35, 1.1)
        elif r < 0.90:
            kind, dur = "fricative", rng.uniform(0.04, 0.10)
        else:
            kind, dur = "pause", rng.uniform(0.10, 0.35)
        plan.append((kind, dur))
        t += dur
    return plan


def synth_utterance(rng: np.random.RandomState, duration_s: float = 3.0, sr: int = 24000,
                    f0_base: Optional[float] = None,
                    style: str = "speech", shifted: bool = False,
                    balance: str = "natural") -> Tuple[np.ndarray, np.ndarray]:
    """One utterance: returns (audio float32 in [-1,1], f0 contour at sr).

    style="speech": prosodic F0 drift + declination, syllabic segments.
    style="singing": note-quantized melody with vibrato, sustained voicing
    (for SING/VOICE-family training corpora).

    shifted=True draws every voice parameter from deliberately
    NON-overlapping ranges (higher/lower pitch registers, +18% formant
    frequencies, steeper spectral tilt, faster+deeper vibrato): an
    out-of-distribution eval variant, so the quality gate also measures
    generalization instead of only held-out-same-distribution error.

    balance="natural" (default) mixes fricative noise at a drawn level 8-20 dB
    BELOW the voiced-segment RMS, the level relation of real voices.
    balance="legacy" reproduces the v1 corpora bit-exactly (fixed absolute
    fricative amplitude): there the resonator cascade attenuates the voiced
    path so much that fricative bursts dominate peak normalization, leaving
    voiced content ~15 dB down — which made the v1 mel-L1 quality gate partly
    measure easy noise resynthesis (round-3 diagnosis,
    tools/diagnose_sing_eval.py). Keep "legacy" only to regenerate the
    provenance corpora of pre-v2 published checkpoints."""
    n = int(duration_s * sr)
    formant_scale = 1.18 if shifted else 1.0

    if style == "singing":
        if f0_base is None:
            f0_base = rng.uniform(95, 145) if shifted else rng.uniform(150, 380)
        f0 = _singing_f0(rng, n, sr, f0_base)
        if shifted:  # faster, deeper vibrato register on top of the melody
            extra = 2.0 ** ((rng.uniform(30, 60) / 1200.0)
                            * np.sin(2 * np.pi * rng.uniform(7.0, 8.0) * np.arange(n) / sr))
            f0 = np.clip(f0 * extra, 45.0, 580.0)
        plan = _singing_plan(rng, duration_s)
    elif style == "speech":
        if f0_base is None:
            f0_base = rng.uniform(250, 360) if shifted else rng.uniform(90, 240)
        # F0: slow prosodic drift + declination + jitter, bounded to the
        # model's pp range (40-600 Hz)
        f0 = _smooth_contour(rng, n, sr, f0_base * 0.8, f0_base * 1.45, 0.35)
        f0 *= np.linspace(1.05, 0.92, n)  # declination
        f0 *= 1.0 + 0.003 * rng.randn(n)  # jitter
        f0 = np.clip(f0, 45.0, 580.0)
        plan = _segment_plan(rng, duration_s)
    else:
        raise ValueError(f"unknown style {style!r} (speech|singing)")
    voiced_mask = np.zeros(n)
    fric_mask = np.zeros(n)
    t0 = 0
    for kind, dur in plan:
        t1 = min(n, t0 + int(dur * sr))
        if kind == "voiced":
            voiced_mask[t0:t1] = 1.0
        elif kind == "fricative":
            fric_mask[t0:t1] = 1.0
        t0 = t1
        if t0 >= n:
            break
    # 8 ms on/off ramps avoid clicks
    ramp = int(0.008 * sr)
    kern = np.hanning(2 * ramp + 1)
    kern /= kern.sum()
    voiced_mask = ss.fftconvolve(voiced_mask, kern, mode="same")
    fric_mask = ss.fftconvolve(fric_mask, kern, mode="same")

    # glottal-ish source: band-limited pulse train via additive harmonics with
    # 1/k rolloff and a per-utterance spectral tilt
    phase = np.cumsum(f0) / sr
    tilt = rng.uniform(1.7, 2.4) if shifted else rng.uniform(0.8, 1.6)
    max_harm = int(10000 / f0.min())
    src = np.zeros(n)
    k = 1
    while k <= max_harm:
        active = (k * f0) < 10000.0
        src += np.where(active, np.sin(2 * np.pi * k * phase) / (k ** tilt), 0.0)
        k += 1
    src *= voiced_mask
    # aspiration floor under voicing
    src += 0.02 * voiced_mask * rng.randn(n)

    voiced = _formant_filter(rng, src, sr, n_blocks=max(4, int(duration_s / 0.06)),
                             formant_scale=formant_scale)

    # fricatives: shaped high-band noise
    noise = rng.randn(n)
    b, a = ss.butter(4, [2000 / (sr / 2), 9000 / (sr / 2)], btype="band")
    fric = ss.lfilter(b, a, noise) * fric_mask * 0.5

    if balance == "natural":
        # mix fricatives relative to the voiced level the way real voices
        # sit: consonant noise 8-20 dB below the vowel RMS (singing lower
        # than speech). The resonator cascade's gain varies wildly with the
        # harmonic/formant alignment, so measure, don't assume.
        v_act = voiced_mask > 0.5
        f_act = fric_mask > 0.5
        v_rms = float(np.sqrt(np.mean(voiced[v_act] ** 2))) if v_act.any() else 0.0
        f_rms = float(np.sqrt(np.mean(fric[f_act] ** 2))) if f_act.any() else 0.0
        rel_db = rng.uniform(-20.0, -12.0) if style == "singing" else rng.uniform(-16.0, -8.0)
        if v_rms > 0.0 and f_rms > 0.0:
            fric *= (v_rms / f_rms) * 10.0 ** (rel_db / 20.0)
    elif balance != "legacy":
        raise ValueError(f"unknown balance {balance!r} (natural|legacy)")

    audio = voiced + fric
    # loudness modulation: syllabic for speech, phrase-level swells for singing
    amp_tau = 0.6 if style == "singing" else 0.22
    amp_floor = 0.7 if style == "singing" else 0.55
    audio *= amp_floor + (1.0 - amp_floor) * _smooth_contour(rng, n, sr, 0.0, 1.0, amp_tau)
    peak = np.abs(audio).max() + 1e-9
    audio = (audio / peak * rng.uniform(0.45, 0.8)).astype(np.float32)
    return audio, np.where(voiced_mask > 0.5, f0, 0.0).astype(np.float32)


def make_corpus(out_dir: str, n_utterances: int = 32, seed: int = 0,
                duration_range=(2.0, 4.0), sr: int = 24000, quiet: bool = False,
                style: str = "speech", shifted: bool = False,
                balance: str = "natural") -> list:
    """Write n synthetic utterances as float32 wavs; returns the file list.

    style: "speech" | "singing" | "mixed" (alternating — the VOICE-family
    universal corpus).  shifted=True produces the out-of-distribution eval
    variant; balance="legacy" the v1 fricative mix (see synth_utterance)."""
    from ..compat.audio_io import write_wav

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n_utterances):
        dur = rng.uniform(*duration_range)
        ustyle = style if style != "mixed" else ("singing" if i % 2 else "speech")
        audio, _ = synth_utterance(rng, duration_s=dur, sr=sr, style=ustyle, shifted=shifted,
                                   balance=balance)
        path = os.path.join(out_dir, f"synthetic_{seed:03d}_{i:04d}.wav")
        write_wav(path, audio, sr)
        paths.append(path)
        if not quiet:
            print(f"wrote {path} ({dur:.2f}s, {ustyle}{', shifted' if shifted else ''})")
    return paths
