"""MBExWN vocoder in PyTorch for NVIDIA Hopper (H100).

The port of the JAX package `mbexwn_vocoder_tpu`, which stays beside it as
the reference.  Module names mirror the JAX package's so each counterpart is
easy to find; the two hand-written CUDA kernels live in `csrc/` and are
built at first use (ops/kernel_lib.py).

This package imports neither `jax` nor anything of `mbexwn_vocoder_tpu`.
It reads the shipped registry files (`config.yaml`, `weights.npz`) by path
only, so the weights are not duplicated.
"""
from __future__ import annotations

import copy
import os
from pathlib import Path
from typing import Dict, List, Optional

# The shipped model directories, found by path under the JAX package's
# registry folder (data only; no module of that package is imported).
REGISTRY_DIR = Path(__file__).absolute().parent.parent / "mbexwn_vocoder_tpu" / "models_registry"

_mel_inv_models: Dict[str, List[str]] = {
    "SING": ["MBExWN_TPU_SING_WNCHA320_24kHz"],
    "SPEECH": ["MBExWN_TPU_SPEECH_WNCHA320_24kHz"],
    "VOICE": ["MBExWN_TPU_VOICE_WNCHA340_24kHz"],
}


def list_models(voice_type: Optional[str] = None) -> Dict[str, List[str]]:
    """Known mel-inverter model ids per voice domain."""
    if voice_type is None:
        return copy.deepcopy(_mel_inv_models)
    return copy.deepcopy({voice_type: _mel_inv_models[voice_type]})


def get_config_file(model_id_or_path: str) -> str:
    """Resolve a model id (substring match) or a directory to its config.yaml."""
    model_dir = None
    if os.path.exists(model_id_or_path):
        model_dir = model_id_or_path
    else:
        for kk, ll in list_models().items():
            for md in ll:
                if model_id_or_path in f"{kk}/{md}":
                    model_dir = REGISTRY_DIR / md
                    break
            if model_dir is not None:
                break
    if model_dir is None:
        raise FileNotFoundError(f"no model matching {model_id_or_path} in registry {list_models()}")
    config_file = os.path.join(model_dir, "config.yaml")
    if not os.path.exists(config_file):
        raise FileNotFoundError(f"no config file at {config_file}")
    return config_file
