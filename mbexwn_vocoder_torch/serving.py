"""Serving: a depth-bounded software pipeline with micro-batch coalescing.

Counterpart of the JAX package's serving.py.  At batch 1 the card idles
while the host dispatches a synthesis op by op and reads the audio back, so
the host keeps up to `depth` dispatch groups in flight and blocks only on
the oldest: the host's dispatch of group i+1 overlaps the card's work on
group i and the readback and file writes of earlier groups.  Up to `batch`
consecutive utterances of one length bucket are stacked into one group,
which pays the host's dispatch once for all of them.

The JAX version leans on XLA's asynchronous dispatch.  Here each group is
enqueued on the current stream: its mel goes to the card from pinned host
memory without blocking, the synthesis is enqueued, its audio is copied
into a pinned host buffer without blocking, and a CUDA event is recorded
after the copy.  Collecting a group waits on its event only; nothing
synchronises the whole device.  The pinned buffers come from
`torch.empty(..., pin_memory=True)`, which PyTorch's caching host
allocator serves from blocks it keeps (a block goes back to it only once
the copies recorded on it have completed).  On the CPU the same loop runs
synchronously.

Shapes follow `MELInverter.synth_from_mel`: edge-padded to length buckets,
the padded audio tail trimmed.  At batch 1 a result is bit-equal to
`synth_from_mel` of the same mel.  In a group of several, the noise channel
of row i is row i of one (B, L, 1) draw (a generator seeded 0), so it
differs from a single request's draw, as in the JAX package.  Results come
back in submission order.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Sequence, Union

import numpy as np
import torch

from .mel_inverter import bucket_len, edge_pad
from .observability import SERVING_COLLECT_WAIT, SERVING_DISPATCH, span
from .platform import resolve_device


class PipelinedSynthesizer:
    def __init__(self, model: torch.nn.Module, length_buckets=(128, 256, 512, 1024, 2048), depth: int = 3,
                 batch: int = 8, device: Union[str, torch.device] = "cuda"):
        """model: a `PaNWaveNet` with its weights (moved to `device`).
        depth: dispatch groups in flight.  batch: up to `batch` consecutive
        same-bucket utterances are stacked into one group; a group also
        flushes on a bucket change and at the end of the stream, so a single
        request still dispatches at once.  Coalescing is on by default
        (batch=8); batch=1 gives one request per dispatch, the lowest latency
        per request under sustained load."""
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if batch < 1:
            raise ValueError(f"micro-batch size must be >= 1, got {batch}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.length_buckets = tuple(sorted(length_buckets))
        self.depth = depth
        self.batch = batch

    def _bucket_len(self, T: int) -> int:
        return bucket_len(T, self.length_buckets)

    def _synthesize(self, mell: torch.Tensor) -> torch.Tensor:
        """(B, T_pad, C) mel on the device -> (B, T_pad * hop) audio, enqueued."""
        with torch.inference_mode():
            return self.model.infer(mell, synth_length=mell.shape[1] * self.model.spect_hop_size)

    def warm(self, buckets=None) -> None:
        """One batch-1 synthesis per length bucket (all configured buckets by
        default): builds the CUDA kernels and lets cuDNN pick its algorithms
        and the allocator its blocks before serving."""
        n_mel = self.model.mel_channels
        for b in buckets or self.length_buckets:
            self._collect(*self._dispatch_group([(np.full((1, b, n_mel), -10.0, np.float32), b)], b))

    # -- pipeline -----------------------------------------------------------
    def _prep(self, mel: np.ndarray):
        """Validate + bucket-pad one utterance -> ((1, T_pad, C), T, T_pad)."""
        mel = np.asarray(mel, dtype=np.float32)
        if mel.ndim == 2:
            mel = mel[None]
        if mel.ndim != 3 or mel.shape[0] != 1:
            raise ValueError(f"expected one utterance (T, C) or (1, T, C), got {mel.shape}")
        T = mel.shape[1]
        T_pad = self._bucket_len(T)
        return edge_pad(mel, T_pad), T, T_pad

    def _dispatch_group(self, group, T_pad):
        """Enqueue one micro-batch; returns (audio, the CUDA event after its
        copy to the host or None on the CPU, [true T...]).  Does not wait for
        the device."""
        with span(SERVING_DISPATCH):
            stack = group[0][0] if len(group) == 1 else np.concatenate([m for m, _ in group], axis=0)
            Ts = [t for _, t in group]
            if self.device.type != "cuda":
                return self._synthesize(torch.from_numpy(np.ascontiguousarray(stack))), None, Ts
            mell = torch.empty(stack.shape, dtype=torch.float32, pin_memory=True)
            mell.numpy()[...] = stack
            y = self._synthesize(mell.to(self.device, non_blocking=True))
            audio = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            audio.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return audio, done, Ts

    def _collect(self, audio, done, Ts) -> List[np.ndarray]:
        with span(SERVING_COLLECT_WAIT):
            if done is not None:
                done.synchronize()
        hop = self.model.spect_hop_size
        y = audio.numpy()
        return [y[i, : T * hop] for i, T in enumerate(Ts)]

    def stream(self, mells: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Yield waveforms in submission order, keeping up to `depth` dispatch
        groups (of up to `batch` same-bucket utterances each) in flight."""
        inflight: deque = deque()
        pending: List = []
        pend_pad = None
        for mel in mells:
            mel, T, T_pad = self._prep(mel)
            if pending and T_pad != pend_pad:
                inflight.append(self._dispatch_group(pending, pend_pad))
                pending = []
            pending.append((mel, T))
            pend_pad = T_pad
            if len(pending) >= self.batch:
                inflight.append(self._dispatch_group(pending, pend_pad))
                pending = []
            while len(inflight) >= self.depth:
                yield from self._collect(*inflight.popleft())
        if pending:
            inflight.append(self._dispatch_group(pending, pend_pad))
        while inflight:
            yield from self._collect(*inflight.popleft())

    def map(self, mells: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Pipelined equivalent of [synth(m) for m in mells]."""
        return list(self.stream(mells))
