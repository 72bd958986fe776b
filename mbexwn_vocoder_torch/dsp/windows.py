"""Analysis windows (libfft/supervp-compatible cosine-sum family) and the
periodic Hann window of the excitation-path STFT.

Copy of the JAX package's dsp/windows.py: same window-type names, same
coefficient sets, same symmetric mirror construction.  Init-time and
analysis-side NumPy only (never on the synthesis hot path).
"""
from __future__ import annotations

import numpy as np

# Cosine-sum coefficient table (a1, a2, a3, a4).  These are the standard
# published coefficients for each window family; the set of names matches the
# reference's supported list (Mwindows.py:39-55 docstring).
_COS_COEFS = {
    "hanning": (0.5, -0.5, 0.0, 0.0),
    "hann": (0.5, -0.5, 0.0, 0.0),
    "hamming": (0.54, -0.46, 0.0, 0.0),
    "exactblackman": (0.42659, -0.49656, 0.07685, 0.0),
    "blackman": (0.42, -0.5, 0.08, 0.0),
    "blackmanharris_3_1": (0.42323, -0.49755, 0.07922, 0.0),
    "blackmanharris_3_2": (0.44959, -0.49364, 0.05677, 0.0),
    "blackmanharris_4_1": (0.35875, -0.48829, 0.14128, -0.01168),
    "blackmanharris_4_2": (0.40217, -0.49703, 0.09392, -0.001830),
    "hanning2": (0.375, -0.5, 0.125, 0.0),
    "nuttall3_30db": (0.375, -0.5, 0.125, 0.0),
    "nuttall3_18db": (0.40897, -0.5, 0.09103, 0.0),
    "nuttall4_6db": (0.3635819, -0.4891775, 0.1365995, -0.0106411),
    "nuttall4_30db": (0.338946, -0.481973, 0.161054, -0.018027),
    "nuttall4_42db": (10.0 / 32.0, -15.0 / 32.0, 6.0 / 32.0, -1.0 / 32.0),
}

# Max error acceptable in the I0 Bessel series (Mwindows.py:13-14)
_IZERO_EPSILON = 1e-21


def _izero(x: float) -> float:
    """Zeroth-order modified Bessel function via power series (Mwindows.py:16-26)."""
    s = u = n = 1.0
    halfx = x / 2.0
    while u >= _IZERO_EPSILON * s:
        temp = halfx / n
        n += 1.0
        temp *= temp
        u *= temp
        s += u
    return s


def mhanning(M: int) -> np.ndarray:
    """Hanning window excluding boundary zeros (matlab `hanning`).

    reference: MBExWN_NVoc/sig_proc/Mwindows.py:188-200
    """
    if M < 1:
        return np.array([])
    if M == 1:
        return np.ones(1, float)
    n = np.arange(1, M + 1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (M + 1))


def window(win_type: str, winlen: int, para=None) -> np.ndarray:
    """Generate a window of length `winlen`.

    Same name set and symmetric-mirror evaluation as the reference generator
    (Mwindows.py:29-185): the first half is evaluated on x=0..mid with
    Nmax = winlen-1 and mirrored onto the second half.
    """
    win_type = win_type.lower()
    win = np.zeros((winlen,))
    mid = (winlen - 1) // 2

    if win_type == "mhanning":
        return mhanning(winlen)

    if win_type.startswith("rect") or win_type.startswith("box"):
        return np.ones((winlen,))

    if win_type.startswith("triang") or win_type == "bartlett":
        rmid = (winlen - 1.0) / 2.0
        slope = 1.0 / rmid
        half = slope * np.arange(mid + 1)
        win[: mid + 1] = half
        win[winlen - 1 : winlen - 2 - mid : -1] = half
        return win

    if win_type == "gauss":
        if not para:
            raise RuntimeError("window::cannot calculate Gauss window without a width parameter")
        sigma = float(winlen) / para
        offset = -winlen / 2.0 - 0.5
        x = offset + np.arange(winlen)
        return np.exp(-(x * x) / (2 * sigma * sigma))

    if win_type == "kaiser":
        beta = para
        ibeta = 1.0 / _izero(beta)
        alpha = (winlen - 1.0) / 2.0
        n = np.arange(winlen)
        t1 = (n - alpha) / alpha
        arg = np.sqrt(np.fmax(1.0 - t1 * t1, 0.0))
        return np.array([ibeta * _izero(beta * a) for a in arg])

    if win_type not in _COS_COEFS:
        raise RuntimeError(f"window::unsupported window type {win_type}")

    a1, a2, a3, a4 = _COS_COEFS[win_type]
    nmax = winlen - 1
    x = np.arange(mid + 1)
    half = (
        a1
        + a2 * np.cos(2.0 * np.pi * x / nmax)
        + a3 * np.cos(4.0 * np.pi * x / nmax)
        + a4 * np.cos(6.0 * np.pi * x / nmax)
    )
    win[: mid + 1] = half
    win[winlen - 1 : winlen - 2 - mid : -1] = half
    return win


def get_stft_window(win_type: str, win_len: int, dtype=np.float32) -> np.ndarray:
    """reference: MBExWN_NVoc/sig_proc/spec/stft.py:11-12"""
    return window(win_type=win_type, winlen=win_len).astype(dtype)


def hann_periodic(win_len: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, matching tf.signal.hann_window(periodic=True).

    Used by the excitation-path STFT (custom_pulsed_generator.py:388,692-694).
    """
    n = np.arange(win_len)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_len)).astype(dtype)
