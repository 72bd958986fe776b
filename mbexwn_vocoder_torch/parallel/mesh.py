"""The devices a process synthesises over.

Counterpart of the JAX package's parallel/mesh.py.  A `Mesh` is the list of
local devices of the "data" axis: utterance batches (and the chunk groups of
long-form synthesis) are split into contiguous shards, one per device, each
run by a replica of the model on that device.  The "model" axis, sharding
the WaveNet's channels over devices (the JAX package's `tp_axis`), is not
ported: no registry model needs it, since the shipped 320-340 channel models
fit one card many times over.

A device may appear more than once (`["cuda:0", "cuda:0"]`): its shards then
share the device's replica and run one after another, which exercises the
shard, pad and gather code on a host with one card.  Training is data
parallel over processes, one per card (`parallel.multihost`), not over a
mesh inside one process.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..platform import resolve_device

AXES = ("data", "model")
TP_ITEM = "ROADMAP.md queue 1, item 13d: tensor parallelism over the WaveNet channels"


@dataclass(frozen=True)
class Mesh:
    """Local devices along the "data" axis (the "model" axis has size 1)."""
    devices: Tuple[torch.device, ...]

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}

    @property
    def first(self) -> torch.device:
        """The device of everything that is not split: the carries, the
        edge chunk groups of long form, the gathered results."""
        return self.devices[0]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A mesh of `n_data` devices (default: all of `devices`).  `devices`
    defaults to every visible card; without a card that raises, there is no
    fallback to the CPU (pass `devices=["cpu", "cpu"]` to shard on the CPU).
    `n_model > 1` raises: tensor parallelism is not ported."""
    if n_model != 1:
        raise NotImplementedError(f"a mesh with a model axis of {n_model} is not ported ({TP_ITEM})")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the mesh; pass devices=['cpu', ...] to shard on "
                               "the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    devices = [torch.device(d.type, 0) if d.type == "cuda" and d.index is None else d for d in devices]
    n_data = len(devices) if n_data is None else n_data
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"make_mesh: n_data={n_data} with {len(devices)} devices")
    return Mesh(tuple(devices[:n_data]))


def shard_bounds(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """The contiguous [lo, hi) rows of each shard; n_rows must be a multiple
    of n_shards."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split into {n_shards} equal shards")
    per = n_rows // n_shards
    return [(i * per, (i + 1) * per) for i in range(n_shards)]


def replicate(model: torch.nn.Module, mesh: Mesh) -> Dict[torch.device, torch.nn.Module]:
    """One replica of `model` per distinct mesh device: the model itself on
    the first device, a copy on every other.  The copies start without the
    kernel-layout weights a WaveNet caches (they hold device pointers)."""
    import copy

    replicas = {mesh.first: model.to(mesh.first)}
    for dev in mesh.distinct_devices()[1:]:
        memo = {id(m._stack_cache): None for m in model.modules() if getattr(m, "_stack_cache", None) is not None}
        replicas[dev] = copy.deepcopy(model, memo).to(dev)
    return replicas
