"""Weights: the registry's flat .npz of slash-joined parameter paths, and
the map from that (JAX-layout) tree onto this package's modules.

`load_params` reads the npz (an fp16 distribution copy, marked by the
`__distribution_dtype__` sidecar key, is upcast to fp32).  After
`ops.conv.fold_weight_norm`, `params_from_jax` turns the flat tree into a
state_dict of `models.MBExWN`: module paths are the JAX paths with "/" read
as ".", a conv `kernel` (width, in, out) becomes the OIW `weight`, `b`
becomes `bias`; PReLU `alpha` and the `wavetables` keep their names and
layout.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_DIST_DTYPE_KEY = "__distribution_dtype__"


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {slash/joined/path: array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params(path: str) -> dict:
    """Read a flat .npz into a nested parameter tree (fp16 distribution
    copies upcast to fp32)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    dist_dtype = flat.pop(_DIST_DTYPE_KEY, None)
    if dist_dtype is not None:
        dd = np.dtype(str(dist_dtype))
        flat = {k: (v.astype(np.float32) if v.dtype == dd else v) for k, v in flat.items()}
    tree = _unflatten(flat)
    return _restore_flags(tree)


def _restore_flags(tree):
    """npz stores python bools as 0-d arrays; restore the _equalized_lr flag."""
    if isinstance(tree, dict):
        return {k: (bool(v) if k == "_equalized_lr" else _restore_flags(v)) for k, v in tree.items()}
    return tree


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Folded flat JAX parameters -> state_dict of `models.MBExWN`."""
    state = {}
    for path, value in flat.items():
        *mod, leaf = path.split("/")
        value = np.asarray(value)
        if leaf == "kernel":
            name, value = "weight", np.ascontiguousarray(value.transpose(2, 1, 0))
        elif leaf == "b":
            name = "bias"
        elif leaf in ("alpha", "wavetables"):
            name = leaf
        else:
            raise KeyError(f"params_from_jax: unexpected parameter {path} (fold weight norm first)")
        state[".".join(mod + [name])] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state
