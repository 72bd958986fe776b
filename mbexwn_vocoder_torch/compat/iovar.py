"""Pickle (+gzip) variable IO, format-compatible with the `.mell` files of
the JAX package and the reference (keys: mell|mel, nfft, hoplen, winlen,
nmels, sr, fmin, fmax, lin_spec_offset/scale, log_spec_offset/scale,
time_axis).  Copy of the JAX package's compat/iovar.py.

Unpickling runs code: load only files this program or a trusted tool wrote.
"""
from __future__ import annotations

import gzip
import pickle as std_pickle

try:
    import dill

    serializer = dill
    have_dill = True
except ImportError:
    have_dill = False
    serializer = std_pickle


def save_var(filename, data, protocol=-1, allow_dill=False):
    """Serialize `data` to `filename` (gzip if the name ends with .gz)."""
    open_method = gzip.open if filename.endswith(".gz") else open
    with open_method(filename, "wb") as output:
        if allow_dill and have_dill:
            dill.dump(data, output, protocol)
        else:
            std_pickle.dump(data, output, protocol)


def load_var(filename):
    """Load data stored with save_var (tolerates py2-era latin1 pickles)."""
    open_method = gzip.open if filename.endswith(".gz") else open
    try:
        with open_method(filename, "rb") as infile:
            return serializer.load(infile)
    except UnicodeDecodeError:
        with open_method(filename, "rb") as infile:
            return std_pickle.load(infile, encoding="latin1")
    except ValueError:
        if have_dill:
            with open_method(filename, "rb") as infile:
                return std_pickle.load(infile)
        raise
