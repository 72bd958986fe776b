"""Minimal audio file IO: WAV (PCM 8/16/32-bit or float32) through
scipy.io.wavfile.  Copy of the JAX package's compat/audio_io.py."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile


def read_wav(path):
    """Returns (float32 samples in [-1, 1], sample_rate); channels are mixed down."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, sr


def write_wav(path, data, sr, subtype="float32"):
    """Write float32 samples, or clipped 16-bit PCM with subtype="pcm16"."""
    data = np.asarray(data)
    if subtype == "pcm16":
        data = np.clip(data, -1.0, 1.0)
        wavfile.write(path, sr, (data * 32767.0).astype(np.int16))
    else:
        wavfile.write(path, sr, data.astype(np.float32))
