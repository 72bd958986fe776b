"""Linear <-> dB conversion helpers (copy of the JAX package's dsp/db.py)."""
import numpy as np

# 20*log10(e): factor converting natural-log amplitudes to dB
log_to_db = 20.0 * np.log10(np.exp(1.0))


def lin2db(vec, l_no_abs=False, minthresh=None):
    if l_no_abs:
        if minthresh is None:
            return 20.0 * np.log10(vec)
        return 20.0 * np.log10(np.fmax(vec, minthresh))
    if minthresh is None:
        return 20.0 * np.log10(np.abs(vec))
    return 20.0 * np.log10(np.fmax(np.abs(vec), minthresh))


def db2lin(vec):
    return 10 ** (np.asarray(vec) / 20.0)
