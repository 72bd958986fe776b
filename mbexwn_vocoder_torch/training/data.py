"""Training data: a wav directory -> batches of (audio, mel, F0) segments.

Counterpart of the JAX package's training/data.py: random fixed-length
segments, their log-mel from the analysis front end and their F0 target
(YIN at the frame rate, upsampled to the sample rate), on the host in
NumPy; and `PrefetchLoader`, worker threads that keep a queue of batches
ready while the card trains.

The same seed gives the JAX package's segments bit for bit on each of the
two paths.  `SegmentDataset` draws its segments from the native C++ loader
(compat/native_loader.py) when every file of the corpus parses there at the
model's sample rate, else from the Python sampler (which resamples files at
another rate); it prints which path it took and why.  The two paths give
different segment streams, and with more than one native worker the order
of the native stream is not fixed.

Data parallel (`shard=(rank, world)`): every rank draws the same global
batches from the same seed, and `batch(B)` returns the rank's rows [rank *
B / world, (rank + 1) * B / world) of the global batch: the (file, start)
choices are drawn for all B rows (they are cheap), the mel and F0 are
extracted for the rank's rows only, so the analysis per rank falls by the
world size.  A sharded dataset pins the native loader to one worker, so
that every rank's native stream is the one fixed stream.  With one
`PrefetchLoader` thread per rank, rank r's batch at step s is exactly its
rows of the batch the one-process run (one thread) draws at step s; with
more threads, each rank takes its rows of the global batches in the order
its threads finish them, which may differ between ranks: every step still
trains on B distinct random segments, but not on one global batch of the
one-process run.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..analysis import compute_mel_spectrogram_internal
from ..compat import native_loader
from ..compat.audio_io import read_wav
from ..dsp.f0 import estimate_f0, upsample_f0
from ..dsp.resample import resample


def list_audio_files(data_dir: str, exts=(".wav",)) -> List[str]:
    files = []
    for root, _, names in os.walk(data_dir):
        for n in sorted(names):
            if os.path.splitext(n)[1].lower() in exts:
                files.append(os.path.join(root, n))
    if not files:
        raise RuntimeError(f"no audio files found under {data_dir}")
    return files


class SegmentDataset:
    """Random fixed-length segments with per-segment mel + F0 targets.
    `source` is "native" or "python", the path the segments come from."""

    def __init__(self, data_dir: str, preprocess_config: Dict, seed: int = 0,
                 fmin_f0: float = 50.0, fmax_f0: float = 600.0, cache_audio: bool = True,
                 use_native: bool = True, shard: Tuple[int, int] = (0, 1)):
        """shard: (rank, world size) of a data-parallel run (module docstring)."""
        self.files = list_audio_files(data_dir)
        self.rank, self.world = shard
        if not 0 <= self.rank < self.world:
            raise ValueError(f"shard {shard}: rank must be in [0, world)")
        self.pc = dict(preprocess_config)
        self.segment_length = self.pc["segment_length"]
        self.hop = self.pc["hop_size"]
        self.sr = self.pc["sample_rate"]
        self.rng = np.random.RandomState(seed)
        self.fmin_f0 = fmin_f0
        self.fmax_f0 = fmax_f0
        self._cache: Dict[str, np.ndarray] = {}
        self.cache_audio = cache_audio

        self._native = None
        reason = "use_native=False"
        if use_native:
            if not native_loader.available():
                reason = native_loader.load_error()
            else:
                try:
                    loader = native_loader.NativeSegmentLoader(self.files, self.segment_length, self.sr, seed=seed,
                                                               **({"n_workers": 1} if self.world > 1 else {}))
                except RuntimeError as e:
                    reason = str(e)
                else:
                    if loader.n_files == len(self.files):
                        self._native = loader
                        reason = f"every file parses at {self.sr} Hz"
                    else:
                        reason = f"{loader.n_files} of {len(self.files)} files parse natively at {self.sr} Hz"
                        loader.close()
        self.source = "native" if self._native is not None else "python"
        print(f"data: {'native C++ segment loader' if self._native is not None else 'Python segment sampler'} "
              f"over {len(self.files)} files under {data_dir} ({reason})", file=sys.stderr)

    def _load(self, path: str) -> np.ndarray:
        if path in self._cache:
            return self._cache[path]
        snd, sr = read_wav(path)
        if sr != self.sr:
            snd, _ = resample(snd, sr, self.sr, axis=0)
        snd = snd.astype(np.float32)
        if self.cache_audio:
            self._cache[path] = snd
        return snd

    def _choose(self) -> Tuple[str, int]:
        """The next segment's (file, start) from the dataset's RNG."""
        path = self.files[self.rng.randint(len(self.files))]
        n = max(self._load(path).shape[0], self.segment_length)  # a short file is zero-padded to one segment
        return path, self.rng.randint(max(1, n - self.segment_length + 1))

    def _segment(self, path: str, start: int) -> np.ndarray:
        snd = self._load(path)
        L = self.segment_length
        if snd.shape[0] < L:
            snd = np.pad(snd, (0, L - snd.shape[0]))
        return snd[start: start + L]

    def _features(self, seg: np.ndarray) -> Dict[str, np.ndarray]:
        mell, _ = compute_mel_spectrogram_internal(seg[None], preprocess_config=self.pc, do_post=True)
        f0_frames = estimate_f0(seg, self.sr, self.hop, fmin=self.fmin_f0, fmax=self.fmax_f0)
        f0 = upsample_f0(f0_frames, self.hop, seg.shape[0])
        return {"audio": seg, "mel": mell[0].astype(np.float32), "F0": f0}

    def sample_segment(self) -> Dict[str, np.ndarray]:
        """One segment from the dataset's RNG with its features (audio, mel,
        F0), the JAX package's `sample_segment` (the same draws)."""
        return self._features(self._segment(*self._choose()))

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """The next global batch of `batch_size` segments: this rank's rows
        of it (all of them without a shard)."""
        if batch_size % self.world:
            raise ValueError(f"batch_size {batch_size} must be divisible by the data-parallel world size "
                             f"{self.world}")
        n = batch_size // self.world
        rows = slice(self.rank * n, (self.rank + 1) * n)
        if self._native is not None:
            segs = [self._features(a) for a in self._native.next_batch(batch_size)[rows]]
        else:
            segs = [self._features(self._segment(*c)) for c in [self._choose() for _ in range(batch_size)][rows]]
        return {k: np.stack([s[k] for s in segs]) for k in segs[0]}

    def close(self) -> None:
        """Stop the native loader's threads (call once no batch is being made)."""
        if self._native is not None:
            self._native.close()
            self._native = None


class PrefetchLoader:
    """Worker threads that make batches into a queue of `depth` (host IO and
    analysis overlapping the card's step).  An exception in a worker is
    raised by the iterator.  `stats()` gives each batch's making time (per
    worker) and the queue depth each take found."""

    def __init__(self, dataset: SegmentDataset, batch_size: int, num_workers: int = 2, depth: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.batch_ms: List[float] = []
        self.depths: List[int] = []
        self.workers = [threading.Thread(target=self._worker, daemon=True) for _ in range(num_workers)]
        for w in self.workers:
            w.start()

    def _put(self, item) -> None:
        # block until the batch is taken, in short waits so that close() wins
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                batch = self.dataset.batch(self.batch_size)
                self.batch_ms.append(1e3 * (time.perf_counter() - t0))
                self._put(batch)
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            self.depths.append(self.q.qsize())
            item = self.q.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def stats(self) -> Dict[str, float]:
        ms, depths = list(self.batch_ms), list(self.depths)
        return {"batches_made": len(ms), "workers": len(self.workers),
                "ms_per_batch_per_worker_median": float(np.median(ms)) if ms else None,
                "ms_per_batch_per_worker_all": ms, "queue_depth_at_take_mean": float(np.mean(depths)) if depths else None,
                "queue_depth_at_take_min": int(min(depths)) if depths else None, "queue_capacity": self.q.maxsize}

    def close(self, timeout: float = 60.0) -> bool:
        """Stop the workers and wait for them (each finishes the batch it is
        making); True when all have stopped within `timeout` seconds."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        for w in self.workers:
            w.join(max(0.0, deadline - time.monotonic()))
        return not any(w.is_alive() for w in self.workers)
