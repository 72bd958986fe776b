"""The general traffic generator: a mix's parameters (a `traffic/*.json`
file) and the run's seed -> lengths, arrival gaps and log-mels.

Every seed gets the same set of sizes and arrival gaps, in another order,
and mels of its own: the seed changes what is synthesised, not how much.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream...); any whole seed >= 0."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, stream)]))


def stratified_lengths(lo: int, hi: int, n: int, rng: np.random.Generator) -> List[int]:
    """n lengths spread evenly over [lo, hi] (the midpoints of n equal
    strata), in an order drawn from rng."""
    lengths = [int(round(lo + (i + 0.5) / n * (hi - lo))) for i in range(n)]
    return [lengths[i] for i in rng.permutation(n)]


def poisson_gaps(rate: float, n: int, rng: np.random.Generator) -> List[float]:
    """n inter-arrival gaps of a Poisson process at `rate` per second: the
    exponential's quantiles at the midpoints of n equal strata, in an order
    drawn from rng (their mean is 1/rate to within the strata's rounding)."""
    gaps = [-np.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    return [gaps[i] for i in rng.permutation(n)]


def make_mel(n_frames: int, n_mels: int, rng: np.random.Generator) -> np.ndarray:
    """A log-mel (1, n_frames, n_mels) with a spectral tilt, formant-like
    bumps that move, slow level changes and noise, as speech gives; the
    formants' and level's phases come from rng."""
    band = np.arange(n_mels)[None, :]
    t = np.arange(n_frames)[:, None] + rng.integers(0, 10_000)
    tilt = -2.0 - 0.06 * band
    formants = sum(1.5 * np.exp(-0.5 * ((band - (c + 4 * np.sin(2 * np.pi * t / p))) / w) ** 2)
                   for c, p, w in ((8, 97, 3.0), (22, 61, 4.0), (40, 131, 6.0)))
    level = 1.5 * np.sin(2 * np.pi * t / 173.0)
    mel = tilt + formants + level + 0.3 * rng.standard_normal((n_frames, n_mels))
    return mel[None].astype(np.float32)


def mel_pool(lengths: Sequence[int], n_mels: int, seed: int, stream: int) -> List[np.ndarray]:
    """One mel per length, each from its own generator."""
    return [make_mel(T, n_mels, rng_for(seed, stream, i)) for i, T in enumerate(lengths)]
