"""YAML config reading with the registry's include syntax.

Copy of what `read_config` needs from the JAX package's
config/config_utils.py: cross-file includes ``<@CONFIG_DIR@/file:key:...>``,
env/user expansion, dtype-name mapping and ``__defaults__`` fill-in.
"""
from __future__ import annotations

import os
import re
from copy import deepcopy

import numpy as np
import yaml


def _default_base_dir() -> str:
    from .. import REGISTRY_DIR

    return str(REGISTRY_DIR)


# dtype names as the config format spells them; "jnp.bfloat16" is kept as
# the plain name, which the model resolves to torch.bfloat16
_DTYPE_NAMES = {
    "tf.float32": np.float32,
    "tf.float16": np.float16,
    "np.float32": np.float32,
    "np.float16": np.float16,
    "jnp.float32": np.float32,
    "jnp.bfloat16": "bfloat16",
    "float32": np.float32,
    "None": None,
}

_INCLUDE_MARKER = "@CONFIG_DIR@"


def _load_include(spec: str, base_dir: str):
    """Load ``file[:key[:key...]]`` and walk down the key path."""
    path, *key_path = spec.split(":")
    node = read_config(path, config_base_dir=base_dir)
    for key in key_path:
        node = node[key]
    return node


def _resolve_node(node, base_dir: str):
    """Recursively expand dtype names, env vars and cross-file includes."""
    if isinstance(node, dict):
        return {key: _resolve_node(child, base_dir) for key, child in node.items()}
    if isinstance(node, list):
        return [_resolve_node(child, base_dir) for child in node]
    if not isinstance(node, str):
        return node
    if node in _DTYPE_NAMES:
        return _DTYPE_NAMES[node]
    if "$" in node:
        node = os.path.expandvars(node)
    if "~" in node:
        node = os.path.expanduser(node)
    text = node.strip()
    if text.endswith(">") and _INCLUDE_MARKER in text:
        spec = re.sub(rf"<{_INCLUDE_MARKER}/(.*)>$", rf"{base_dir}/\1", text)
        if spec != text:
            return _load_include(spec, base_dir)
    return node


def _expand_defaults(node):
    """Apply ``__defaults__`` blocks: inside a dict they backfill missing
    sibling keys; inside a list (as a single-key dict element) they backfill
    every other element, all of which must be dicts."""
    if isinstance(node, dict):
        filled = dict(node)
        template = filled.pop("__defaults__", None)
        if template is not None:
            for key, value in template.items():
                filled.setdefault(key, value)
        return {key: _expand_defaults(value) for key, value in filled.items()}
    if isinstance(node, list):
        template = None
        rest = []
        for element in node:
            if isinstance(element, dict) and set(element.keys()) == {"__defaults__"}:
                if template is not None:
                    raise RuntimeError(f"config::defaults: a list may carry at most one __defaults__ element: {node}")
                template = element["__defaults__"]
            else:
                rest.append(element)
        if template is not None:
            for element in rest:
                if not isinstance(element, dict):
                    raise RuntimeError(f"config::defaults: __defaults__ in a list requires dict elements: {element!r}")
                for key, value in template.items():
                    element.setdefault(key, deepcopy(value))
        return [_expand_defaults(element) for element in rest]
    return node


def read_config(config_file, config_base_dir=None):
    """Read one YAML file (or the concatenation of several), then resolve
    includes, dtype names and __defaults__ blocks."""
    base_dir = config_base_dir if config_base_dir is not None else _default_base_dir()
    files = list(config_file) if isinstance(config_file, (list, tuple)) else [config_file]
    chunks = []
    for path in files:
        with open(path, "r") as stream:
            chunks.append(stream.read())
    raw = yaml.safe_load("\n".join(chunks))
    return _expand_defaults(_resolve_node(raw, base_dir))
