"""The devices a process synthesises over.

Counterpart of the JAX package's parallel/mesh.py.  A `Mesh` is an
n_data x n_model grid of local devices.  Along the "data" axis, utterance
batches (and the chunk groups of long-form synthesis) are split into
contiguous shards, one per row, each run by a replica of the model on that
row.  Along the "model" axis, a row's devices share one replica: the
WaveNet stacks of a model built with `MBEXWN_TP_AXIS=model` split their
hidden channels over them (tensor parallelism, parallel/tensor.py); other
models keep their weights replicated and run on the row's first device, as
the JAX package's do without the constraint.

A device may appear more than once (`["cuda:0", "cuda:0"]`): its shards then
share the device's replica and run one after another, which exercises the
shard, pad, reduce and gather code on a host with one card.  Training is
data parallel over processes, one per card (`parallel.multihost`), not over
a mesh inside one process.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..nn.wavenet import WEIGHT_CACHES
from ..platform import resolve_device
from .tensor import shard_model

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """Local devices in n_data rows ("data") of n_model devices ("model")."""
    grid: Tuple[Tuple[torch.device, ...], ...]

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.grid), "model": len(self.grid[0])}

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The data axis: each row's first device, where its replica lives
        and its shard's inputs and outputs go."""
        return tuple(row[0] for row in self.grid)

    @property
    def first(self) -> torch.device:
        """The device of everything that is not split: the carries, the
        edge chunk groups of long form, the gathered results."""
        return self.grid[0][0]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def row(self, device: torch.device) -> Tuple[torch.device, ...]:
        """The model-axis devices of the row whose first device is `device`."""
        return next(r for r in self.grid if r[0] == device)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """An n_data x n_model grid of the first n_data * n_model of `devices`,
    row by row (n_data defaults to len(devices) // n_model).  `devices`
    defaults to every visible card; without a card that raises, there is no
    fallback to the CPU (pass `devices=["cpu"] * n` to run on the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the mesh; pass devices=['cpu', ...] to shard on "
                               "the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    devices = [torch.device(d.type, 0) if d.type == "cuda" and d.index is None else d for d in devices]
    if n_model < 1:
        raise ValueError(f"make_mesh: n_model={n_model}")
    n_data = len(devices) // n_model if n_data is None else n_data
    if n_data < 1 or n_data * n_model > len(devices):
        raise ValueError(f"make_mesh: n_data={n_data} x n_model={n_model} with {len(devices)} devices")
    grid = tuple(tuple(devices[r * n_model:(r + 1) * n_model]) for r in range(n_data))
    rows = {}
    for r in grid:
        if rows.setdefault(r[0], r) != r:
            raise ValueError(f"make_mesh: two rows start on {r[0]} with different model devices")
    return Mesh(grid)


def shard_bounds(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """The contiguous [lo, hi) rows of each shard; n_rows must be a multiple
    of n_shards."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split into {n_shards} equal shards")
    per = n_rows // n_shards
    return [(i * per, (i + 1) * per) for i in range(n_shards)]


def replicate(model: torch.nn.Module, mesh: Mesh) -> Dict[torch.device, torch.nn.Module]:
    """One replica of `model` per distinct row of the mesh, keyed by the row's
    first device: the model itself on the first device, a copy on every
    other, each placed on its row's model devices (`shard_model`).  The
    copies start without the weights a WaveNet caches (they hold device
    pointers)."""
    import copy

    replicas = {mesh.first: model.to(mesh.first)}
    for dev in mesh.distinct_devices()[1:]:
        memo = {id(c): None for m in model.modules() for c in (getattr(m, a, None) for a in WEIGHT_CACHES)
                if c is not None}
        replicas[dev] = copy.deepcopy(model, memo).to(dev)
    if mesh.shape["model"] > 1:
        for dev, replica in replicas.items():
            shard_model(replica, mesh.row(dev))
    return replicas
