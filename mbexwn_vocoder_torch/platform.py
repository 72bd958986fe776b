"""Device selection, the counterpart of the JAX package's platform.py.

Every entry point of the port runs on the card unless it is asked for the
CPU: the classes take `device="cpu"`, the command-line tools read
`MBEXWN_PLATFORM=cpu`.  There is no automatic fallback: asking for the card
on a host without one raises.
"""
from __future__ import annotations

import os
from typing import Union

import torch

PLATFORM_ENV = "MBEXWN_PLATFORM"
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device without a card raises (no silent
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (or set MBEXWN_PLATFORM=cpu) "
                           "to run on the CPU")
    return device


def platform_device() -> torch.device:
    """The device `MBEXWN_PLATFORM` names: `cpu`, or `cuda`/`gpu` (the
    default when it is unset or empty)."""
    name = (os.environ.get(PLATFORM_ENV) or "cuda").lower()
    if name not in _PLATFORMS:
        raise ValueError(f"{PLATFORM_ENV}={name!r}: expected one of {sorted(_PLATFORMS)}")
    return resolve_device(_PLATFORMS[name])
