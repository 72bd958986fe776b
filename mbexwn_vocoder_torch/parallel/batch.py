"""Batched resynthesis over length buckets, on one device or over a mesh.

Counterpart of the JAX package's parallel/batch.py.  Utterances are sorted
by length, grouped by length bucket, edge-padded to the bucket and trimmed
back after synthesis.

Without a mesh, groups of up to 8 run through `PipelinedSynthesizer` at
batch 8 (the grouping it gives a length-sorted stream), one group
dispatched while the previous one is read back.

Over a mesh (`parallel.mesh.make_mesh`), a group holds up to 8 utterances
per shard; it is padded to a multiple of the shard count (as the JAX
package pads its batch; here with copies of its last utterance) and split into
contiguous shards, one per row of the mesh's "data" axis, each synthesised
by that row's replica of the model.  With a "model" axis, a replica built
with `MBEXWN_TP_AXIS=model` splits its WaveNet channels over its row's
devices (parallel/tensor.py); without the variable its weights are
replicated and it runs on the row's first device.  Every shard of a group is enqueued on its device
before any is read back, and the results are gathered in request order.
The noise channel of each row is the one the same request draws without a
mesh (row i of one draw per run of 8, from a generator seeded 0 on the
mesh's first device, `PipelinedSynthesizer`'s), so a mesh changes only
where and at what batch size each row is synthesised.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..mel_inverter import bucket_len, edge_pad
from ..serving import PipelinedSynthesizer
from .mesh import Mesh, replicate, shard_bounds

CHUNK = 8  # utterances per device batch


class BatchSynthesizer:
    def __init__(self, model: torch.nn.Module, mesh: Optional[Mesh] = None,
                 length_buckets=(128, 256, 512, 1024, 2048), device: Union[str, torch.device] = "cuda"):
        """model: a `PaNWaveNet` with its weights.  With a mesh, `device` is
        not read: the model goes to the mesh's first device and a copy to
        every other."""
        self.mesh = mesh
        if mesh is None:
            self._pipeline = PipelinedSynthesizer(model, length_buckets=length_buckets, depth=2, batch=CHUNK,
                                                  device=device)
            self.model = self._pipeline.model
            self.device = self._pipeline.device
            self.length_buckets = self._pipeline.length_buckets
            self.n_shards = 1
        else:
            self.replicas = replicate(model, mesh)
            self.model = self.replicas[mesh.first]
            self.device = mesh.first
            self.length_buckets = tuple(sorted(length_buckets))
            self.n_shards = mesh.shape["data"]

    def synth_batch(self, mells: Sequence[np.ndarray]) -> List[np.ndarray]:
        """mells: list of (T_i, C) log-mels -> list of (T_i*hop,) waveforms."""
        order = sorted(range(len(mells)), key=lambda i: mells[i].shape[0])
        results: List[Optional[np.ndarray]] = [None] * len(mells)
        if self.mesh is None:
            for i, y in zip(order, self._pipeline.stream(mells[i] for i in order)):
                results[i] = y
            return results
        groups: Dict[int, List[int]] = {}
        for i in order:
            groups.setdefault(bucket_len(mells[i].shape[0], self.length_buckets), []).append(i)
        hop = self.model.spect_hop_size
        for T_pad, idxs in groups.items():
            per_group = CHUNK * self.n_shards
            for start in range(0, len(idxs), per_group):
                chunk = idxs[start: start + per_group]
                audio = self._synth_group([mells[i] for i in chunk], T_pad, start, len(idxs))
                for j, i in enumerate(chunk):
                    results[i] = audio[j, : mells[i].shape[0] * hop]
        return results

    def _noise(self, n_before: int, n_rows: int, n_in_bucket: int, T_pad: int) -> Optional[torch.Tensor]:
        """The noise rows of utterances n_before .. n_before + n_rows of a
        bucket of n_in_bucket, on the mesh's first device: row i of the draw
        of its run of 8 (`PipelinedSynthesizer`'s groups)."""
        rows = [self.model.noise(min(CHUNK, n_in_bucket - run * CHUNK), T_pad, self.device)
                for run in range(n_before // CHUNK, -(-(n_before + n_rows) // CHUNK))]
        if rows[0] is None:
            return None
        return torch.cat(rows)[n_before % CHUNK: n_before % CHUNK + n_rows]

    def _synth_group(self, group: List[np.ndarray], T_pad: int, n_before: int, n_in_bucket: int) -> np.ndarray:
        """(B_pad, T_pad * hop) audio of one group: B padded to a multiple of
        the shard count, one contiguous shard per mesh device, every shard
        enqueued before any is read back."""
        B = len(group)
        B_pad = -(-B // self.n_shards) * self.n_shards
        rows = [edge_pad(np.asarray(m, np.float32)[None], T_pad) for m in group]
        mel = torch.from_numpy(np.concatenate(rows + rows[-1:] * (B_pad - B)))
        noise = self._noise(n_before, B, n_in_bucket, T_pad)
        if noise is not None and B_pad > B:
            noise = torch.cat([noise, noise[-1:].expand(B_pad - B, -1, -1)])
        shards = []
        for dev, (lo, hi) in zip(self.mesh.devices, shard_bounds(B_pad, self.n_shards)):
            shards.append((dev, mel[lo:hi].to(dev), None if noise is None else noise[lo:hi].to(dev)))
        hop = self.model.spect_hop_size
        with torch.inference_mode():
            outs = [self.replicas[dev].infer(m, synth_length=T_pad * hop, noise=nz) for dev, m, nz in shards]
        return np.concatenate([y.cpu().numpy() for y in outs])
