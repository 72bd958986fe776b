"""Batched resynthesis over length buckets on one device.

Counterpart of the JAX package's parallel/batch.py without its device mesh
(data-parallel synthesis over several cards is ROADMAP.md queue 1, item 13).
Utterances are sorted by length, grouped by length bucket in chunks of up to
8, edge-padded to the bucket and trimmed back after synthesis, which is the
grouping `PipelinedSynthesizer` gives a length-sorted stream at batch 8: so
the chunks run through its pipeline, one chunk dispatched while the
previous one is read back.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..serving import PipelinedSynthesizer

CHUNK = 8  # utterances per device batch


class BatchSynthesizer:
    def __init__(self, model: torch.nn.Module, mesh=None, length_buckets=(128, 256, 512, 1024, 2048),
                 device: Union[str, torch.device] = "cuda"):
        if mesh is not None:
            raise NotImplementedError("synthesis over a device mesh is not ported (ROADMAP.md queue 1, item 13)")
        self._pipeline = PipelinedSynthesizer(model, length_buckets=length_buckets, depth=2, batch=CHUNK,
                                              device=device)
        self.model = self._pipeline.model
        self.device = self._pipeline.device
        self.length_buckets = self._pipeline.length_buckets

    def synth_batch(self, mells: Sequence[np.ndarray]) -> List[np.ndarray]:
        """mells: list of (T_i, C) log-mels -> list of (T_i*hop,) waveforms."""
        order = sorted(range(len(mells)), key=lambda i: mells[i].shape[0])
        results: List[Optional[np.ndarray]] = [None] * len(mells)
        for i, y in zip(order, self._pipeline.stream(mells[i] for i in order)):
            results[i] = y
        return results
