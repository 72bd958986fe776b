"""YAML config reading and writing with the registry's include syntax.

Copy of the JAX package's config/config_utils.py without its list helper:
cross-file includes ``<@CONFIG_DIR@/file:key:...>``, env/user expansion,
dtype-name mapping, ``__defaults__`` fill-in, the command-line override
mini-language (``a:b:[i]:key=val``) that `view_mel -a` and `cli.train -a`
take, `dump_config` (the exported model's config.yaml, the same text the JAX
package writes) and the schema validators of the config blocks.
"""
from __future__ import annotations

import ast
import os
import re
import sys
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
_DTYPE_SPELLING = {np.float32: "np.float32", np.float16: "np.float16"}

_WORD_VALUES = {"none": None, "null": None, "true": True, "false": False}


def coerce_scalar(text: str):
    """Interpret an override-value string as the most specific Python value.

    Word forms of None/bool win first; anything that parses as a Python
    literal (int, float, list, dict, quoted string) is taken literally;
    everything else stays a plain string.
    """
    stripped = text.strip()
    lowered = stripped.lower()
    if lowered in _WORD_VALUES:
        return _WORD_VALUES[lowered]
    try:
        return ast.literal_eval(stripped)
    except (ValueError, SyntaxError, MemoryError, RecursionError):
        return text


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


def dump_config(config_file, config):
    """Write a config tree back to YAML (dtype objects re-spelled as names)."""
    parent = os.path.dirname(config_file)
    if parent:
        os.makedirs(parent, exist_ok=True)
    config = _respell_dtypes(deepcopy(config))
    with open(config_file, "w") as stream:
        yaml.safe_dump(config, stream)
    return config


def _respell_dtypes(node):
    if isinstance(node, dict):
        return {key: _respell_dtypes(value) for key, value in node.items()}
    if isinstance(node, type) and node in _DTYPE_SPELLING:
        return _DTYPE_SPELLING[node]
    return node


# CLI override mini-language  (``a:b:[i]:key=val``)

_BRACKET_OPEN = {"{": "}", "[": "]", "<": ">"}
_BRACKET_CLOSE = {close: opener for opener, close in _BRACKET_OPEN.items()}
_INDEX_FORM = re.compile(r"^\s*\[\s*(-?\d+)\s*\]\s*$")


def _split_path(expression: str):
    """Split an override expression on ':' outside of {}/[]/<> nesting."""
    depth = {opener: 0 for opener in _BRACKET_OPEN}
    segments = []
    start = 0
    for pos, char in enumerate(expression):
        if char in _BRACKET_OPEN:
            depth[char] += 1
        elif char in _BRACKET_CLOSE:
            opener = _BRACKET_CLOSE[char]
            depth[opener] -= 1
            if depth[opener] < 0:
                raise RuntimeError(f"config::override: unbalanced '{char}' in {expression!r}")
        elif char == ":" and not any(depth.values()):
            segments.append(expression[start:pos])
            start = pos + 1
    segments.append(expression[start:])
    return segments


def _coerce_or_include(value_text: str, base_dir: str):
    """An override value is either ``<file[:keys]>`` (load + walk) or a
    literal to coerce."""
    if value_text.startswith("<"):
        if not value_text.endswith(">"):
            raise RuntimeError(f"config::override: unterminated file reference {value_text!r}")
        spec = value_text[1:-1].replace(_INCLUDE_MARKER, base_dir or "")
        return deepcopy(_load_include(spec, base_dir))
    return coerce_scalar(value_text)


def _assign(cursor, key_text: str, value, path: str):
    index_match = _INDEX_FORM.match(key_text)
    if isinstance(cursor, list) and index_match:
        index = int(index_match.group(1))
        if index < 0:
            index = len(cursor)
        while len(cursor) <= index:
            cursor.append(None)
        cursor[index] = value
    elif isinstance(cursor, dict) and key_text in cursor:
        cursor[key_text] = value
    else:
        raise RuntimeError(
            f"config::override: {path!r} assigns to key '{key_text}' which does not exist in {cursor}"
        )


def apply_override(config, expression: str, base_dir: str):
    """Apply one nest-aware override expression: descend through plain keys
    and ``[i]`` indices, perform every ``key=value`` assignment at the
    current cursor."""
    cursor = config
    segments = _split_path(expression)
    for position, segment in enumerate(segments):
        if not segment:
            continue
        if "=" in segment:
            key_text, value_text = segment.split("=", 1)
            value = _coerce_or_include(value_text, base_dir)
            _assign(cursor, key_text, value, expression)
            continue
        index_match = _INDEX_FORM.match(segment)
        if index_match:
            cursor = cursor[int(index_match.group(1))]
            continue
        if position == len(segments) - 1:
            raise RuntimeError(
                f"config::override: {expression!r} ends on key '{segment}' with nothing to assign "
                f"(missing '=')"
            )
        if not (isinstance(cursor, dict) and segment in cursor):
            raise RuntimeError(f"config::override: {expression!r} walks through missing key '{segment}'")
        cursor = cursor[segment]


def modify_config(hparams, config_args, config_base_dir=None):
    """Apply a list of override expressions to the config tree (in place).

    Two forms are accepted: the ``path:key=value`` mini-language, and the
    legacy ``path:key:value`` spelling without '='.
    """
    if config_args is None:
        return hparams
    base_dir = config_base_dir if config_base_dir is not None else _default_base_dir()

    for expression in config_args:
        if "=" in expression:
            apply_override(hparams, expression, base_dir)
            continue
        # legacy form: plain ':' split, last element is the value
        parts = expression.split(":")
        if len(parts) < 2:
            raise RuntimeError(f"config::override: {expression!r} carries neither '=' nor a ':'-separated value")
        cursor = hparams
        for key in parts[:-2]:
            cursor = cursor[key]
        if parts[-2] not in cursor:
            raise RuntimeError(
                f"config::override: {expression!r} assigns to key '{parts[-2]}' which does not exist in {cursor}"
            )
        cursor[parts[-2]] = coerce_scalar(parts[-1])
    return hparams


# schema validation: the keys each config block may hold (the shipped
# config.yaml format defines them, so they are a compatibility contract)

_SCHEMAS = {
    "config_dict": dict(
        required=["preprocess_config", "training_config", "checkpoint_config", "pickle_config"],
        optional=[
            "path_config", "mbexwn_config", "wavegan_config", "aliases",
            "use_tf25_compatible_implementation", "parallel_config",
        ],
        obsolete=[],
    ),
    "preprocess_config": dict(
        required=["sample_rate", "segment_length", "hop_size", "mel_channels", "fft_size", "fmin", "fmax"],
        optional=[
            "use_centered_STFT", "win_size", "random_filter_length", "random_filter_amp",
            "random_mult", "random_mult_max_amp", "band_pass", "norm_mel", "mel_amp_scale",
            "lin_amp_scale", "lin_amp_off", "use_max_limit",
        ],
        obsolete=["include_sub_sampled"],
    ),
    "training_config": dict(
        required=["epochs", "epoch_size", "train_batch_size", "ftype", "optimizer"],
        optional=[
            "learning_rate", "reduce_on_plateau", "read_files_max_length_s", "add_speaker_id",
            "file_reader_procs", "batch_creat_procs", "total_loss_debug_thresh",
            "dither_level", "spect_loss_config", "stage", "all_optimizers_start",
            "pretrain_activations_target", "pretrain_activations_max_iters",
            "pretrain_activations_to_rmse", "pretrain_activations_lr",
            "TD_loss_weight", "TD_loss_win_len", "grad_clip_norm", "weight_decay",
            "lr_schedule", "batch_cache_config", "batch_min_cache_perc", "batch_cache_perc",
            "pca_num_steps", "init_inv1x1_with_pca", "output_soft_thresh_fac", "batch_debug_dir",
        ],
        obsolete=["buffer_size", "mixed_precision", "mell_loss_weight", "cpdl_loss_weight", "seed"],
    ),
    "spect_loss_config": dict(
        required=["win_size", "hop_size"],
        optional=[
            "spect_loss_weight", "spect_loss_schedule", "loss_type", "fft_over", "mell_loss_weight",
            "MCCTP_loss_weight", "PP_loss_weight", "BC_loss_weight", "MCCT_loss_weight",
            "MCCTS_loss_weight", "NLL_loss_weight", "MODSPEC_loss_weight", "NPOW_loss_weight",
            "NLL_min_std", "PP_band_width_Hz", "PP_segment_size_s", "PP_loss_method",
            "remove_mean_hz", "BC_segment_size_s", "BC_loss_method", "BC_max_off_Hz",
            "MODSPEC_loss_method", "masking_noise_std", "rel_masking_noise_atten_db",
            "low_band_extra_weight", "low_band_extra_weight_limit_Hz",
            "low_band_extra_weight_transition_Hz", "MCC_segment_size_s", "MCC_pad_size_s",
            "lin_amp_off", "rel_lin_amp_off", "magnitude_compression", "use_lin_amp_off_for_mc",
            "spect_error_gain",
        ],
        obsolete=[
            "cpdl_loss_weight", "MCCT_segment_size_s", "MCCT_pad_size_s", "RIC_loss_weight",
            "RIC_num_filters", "RIC_band_width", "RIC_seed", "RIC_segment_size_s",
        ],
    ),
    "checkpoint_config": dict(
        required=["max_to_keep", "log_dir", "checkpoint_dir", "save_model_every", "show_progress_every",
                  "save_audio_every"],
        optional=["keep_audio_every", "store_model_every"],
        obsolete=[],
    ),
    "wavenet_config": dict(
        required=["n_layers", "n_channels", "kernel_size"],
        optional=[
            "enable_weight_norm", "enable_equalized_lr", "dilation_rate_step", "max_log2_dilation_rate",
            "activation", "return_activations", "weight_schedule", "disabled", "loss_thresh",
            "rel_masking_noise_atten_db",
        ],
        obsolete=["use_weight_norm", "n_in_channels"],
    ),
}


def get_list_parameter(val, n_elements, n_repeater=None, n_repeater_list=None):
    """Broadcast a scalar or short list to exactly ``n_elements`` entries.

    A single value repeats n_elements times; with ``n_repeater`` each entry
    repeats that many times (tail-padded with the last value); with
    ``n_repeater_list`` entry i repeats n_repeater_list[i] times.
    """
    if (n_repeater is not None) and n_repeater_list:
        raise RuntimeError(
            "config::list_parameter: n_repeater and n_repeater_list are mutually exclusive, "
            f"got {n_repeater} and {n_repeater_list}")
    items = list(val) if isinstance(val, (list, tuple)) else [val]
    if len(items) == 1:
        return items * n_elements
    if n_repeater is not None and len(items) * n_repeater < n_elements + n_repeater:
        expanded = [value for value in items for _ in range(n_repeater)]
        expanded.extend(items[-1:] * max(0, n_elements - len(expanded)))
        return expanded[:n_elements]
    if n_repeater_list is not None and int(np.sum(n_repeater_list)) == n_elements:
        return [value for value, count in zip(items, n_repeater_list) for _ in range(count)]
    if len(items) == n_elements:
        return items
    raise RuntimeError(
        f"config::list_parameter: cannot broadcast {val} to {n_elements} entries "
        f"(n_repeater={n_repeater}, n_repeater_list={n_repeater_list})")


def _validate_block(block, schema_name: str):
    schema = _SCHEMAS[schema_name]
    known = set(schema["required"]) | set(schema["optional"]) | set(schema["obsolete"])
    present = set(block)

    unknown = sorted(present - known)
    if unknown:
        raise RuntimeError(f"config::{schema_name}: unrecognized keys {unknown}")
    missing = [key for key in schema["required"] if key not in present]
    if missing:
        raise RuntimeError(f"config::{schema_name}: required keys missing {missing}")
    stale = sorted(present & set(schema["obsolete"]))
    if stale:
        print(f"config::{schema_name}: keys {stale} are obsolete; please update the config", file=sys.stderr)


def check_config_dict(hparams):
    _validate_block(hparams, "config_dict")


def check_preprocess_config(preprocess_config):
    _validate_block(preprocess_config, "preprocess_config")


def check_training_config(training_config):
    _validate_block(training_config, "training_config")


def check_spect_loss_config(spect_loss_config):
    _validate_block(spect_loss_config, "spect_loss_config")


def check_checkpoint_config(checkpoint_config):
    _validate_block(checkpoint_config, "checkpoint_config")


def check_wavenet_config(wavenet_config):
    _validate_block(wavenet_config, "wavenet_config")


def get_model_config(hparams):
    """Return the model-family config block (only mbexwn is supported)."""
    if "mbexwn_config" in hparams:
        return hparams["mbexwn_config"]
    raise RuntimeError(f"config::model: no model-family block among keys {sorted(hparams)}")
