"""Sequential container keyed by layer name.

Layers are registered under the JAX package's layer names, so a state_dict
key is the JAX parameter path with "/" read as "." (compat/params_io.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class Sequential(nn.Module):
    """Applies sub-modules in order; each sub-module has a unique `name`."""

    def __init__(self, layers: Sequence[nn.Module], name: str = "sequential"):
        super().__init__()
        self.name = name
        names = [layer.name for layer in layers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate layer names in {name}: {names}")
        for layer in layers:
            self.add_module(layer.name, layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x

    def out_length(self, in_len: int) -> int:
        for layer in self.children():
            in_len = layer.out_length(in_len)
        return in_len
