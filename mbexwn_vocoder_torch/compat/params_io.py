"""Weights: the registry's flat .npz of slash-joined parameter paths, and
the map from that (JAX-layout) tree onto this package's modules.

`load_params` reads the npz (an fp16 distribution copy, marked by the
`__distribution_dtype__` sidecar key, is upcast to fp32).  `params_from_jax`
turns the flat tree into a state_dict of `models.MBExWN`: module paths are
the JAX paths with "/" read as ".", a folded conv `kernel` (width, in, out)
becomes the OIW `weight` of the folded form, the unfolded `v` (width, in,
out) becomes the trainable form's OIW `v`, `g` stays `g` and the
`_equalized_lr` flag a 0-d bool buffer; `b` becomes `bias`; PReLU `alpha`
and the `wavetables` keep their names and layout.  The WaveNet's own names
map the same way: channel groups (`conv1D_{i}g{g}`, `res_skip_{i}g{g}`),
pre-conditioning convs (`precond_{i}`) and the per-layer `cond` conv.  `params_to_jax` is its
exact inverse, and `save_params` writes the registry's flat npz, which
both packages' `load_params` read.
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


_TRANSPOSED = {"kernel": "weight", "v": "v"}  # WIO (JAX) <-> OIW (here)
_RENAMED = {"b": "bias", "g": "g", "alpha": "alpha", "wavetables": "wavetables"}


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat JAX parameters, folded or not -> state_dict of `models.MBExWN` in
    the matching form (or of the discriminator: its tree
    scale_i/{pre,down_j,post,out}/{v,g,b} maps by the same rules)."""
    state = {}
    for path, value in flat.items():
        *mod, leaf = path.split("/")
        value = np.asarray(value)
        if leaf in _TRANSPOSED:
            name, value = _TRANSPOSED[leaf], np.ascontiguousarray(value.transpose(2, 1, 0))
        elif leaf in _RENAMED:
            name = _RENAMED[leaf]
        elif leaf == "_equalized_lr":
            state[".".join(mod + [leaf])] = torch.tensor(bool(value))
            continue
        else:
            raise KeyError(f"params_from_jax: unexpected parameter {path}")
        # float32 (the npz files, fp16 copies upcast), float64 kept (an fp64 reference's tree)
        dtype = np.float64 if value.dtype == np.float64 else np.float32
        state[".".join(mod + [name])] = torch.from_numpy(np.array(value, dtype=dtype))
    return state


_TO_JAX = {here: jax for jax, here in {**_TRANSPOSED, **_RENAMED, "_equalized_lr": "_equalized_lr"}.items()}


def jax_path(key: str) -> str:
    """The JAX parameter path of a state_dict key (`params_to_jax`'s names)."""
    *mod, leaf = key.split(".")
    if leaf not in _TO_JAX:
        raise KeyError(f"params_to_jax: unexpected state entry {key}")
    return "/".join(mod + [_TO_JAX[leaf]])


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """State_dict of `models.MBExWN` (either form) or of
    `training.discriminator.MultiScaleDiscriminator` -> flat JAX parameters
    {slash/path: ndarray}, the exact inverse of `params_from_jax`."""
    flat = {}
    for key, tensor in state.items():
        leaf = key.rsplit(".", 1)[-1]
        value = tensor.detach().cpu().numpy()
        if leaf == "_equalized_lr":
            value = np.asarray(bool(value))
        elif leaf in _TRANSPOSED.values():
            value = np.ascontiguousarray(value.transpose(2, 1, 0))
        flat[jax_path(key)] = value
    return flat


def save_params(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write flat parameters (`params_to_jax`) as the registry's .npz, in
    float32 (no distribution downcast)."""
    np.savez(path, **flat)
