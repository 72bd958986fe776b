"""Sequence-chunked long-form and live synthesis with exact oscillator phase carry.

Counterpart of the JAX package's parallel/streaming.py, with its chunk
geometry, edge conventions and outputs:

- each chunk [t0, t1) of mel frames is synthesised on the span
  [t0 - halo_frames, t1 + halo_right), clipped to the signal, so every
  interior sample sees its receptive field and STFT overlap; the span's
  audio outside [t0, t1) is dropped;
- the oscillator phase is a prefix sum over the whole utterance.  The phase
  at a chunk's left edge (the carry) is accumulated in fp64 mod 1 from each
  chunk's interior phase increments; the chunk's offset is mod(carry -
  left-halo increment, 1) in fp64 from the span's own F0, cast to fp32 once,
  and goes to the oscillator kernel as its `phase_offset`.  Every mode
  computes both with one pair of helpers (`_phase_offset`, `_phase_carry`).
  The increments are the oscillator's own, F0 times the
  fp32 reciprocal of its rate (`ops.oscillator.phase_velocity`): summing
  F0 / rate instead (the JAX package's carry) misses the oscillator's
  integral by the reciprocal's rounding, 1.07e-8 of it at 12 kHz, which
  over a minute of speech moves the late chunks' phase ~2e-4 cycles from
  the one-shot phase;
- `synth` runs the chunks one after another, `synth_batched` stacks all
  chunks of one shape into one device batch (B x n_chunks rows), with the
  carries from the groups' F0, which the synthesis then takes as given,
  `synth_scan` enqueues every chunk of one uniform span back to back
  against one full-length F0 contour, and
  `stream` consumes mel slabs as they arrive and yields a chunk's audio as
  soon as `halo_right` frames past its end are in.

In PyTorch the chunk programs are not compiled.  `programs` records the
chunk shapes a synthesizer ran, under the JAX package's cache keys ((span,
left, inner) for a chunk, ("f0", span), ("batched", span, left, inner),
("scan", n_chunks, B)), and `warm(B)` runs every shape of the left-halo ramp
once on the device, which lets cuDNN choose its algorithms and the
allocator its blocks before live audio.  On a CUDA device without a mesh,
`warm` then captures each of those shapes as a CUDA graph (one graph memory
pool for all of them): the chunk program after the F0 contour, which is the
offset, the synthesis from that F0, the carry update and the slice, on
static input buffers and with the noise drawn once, the draw the model makes
at that shape.  A chunk whose key was captured (B, span, left, inner, the
dtype, the WaveNet stacks' routes, the device and the weights' versions) runs
the RMS normalisation and the F0 net eagerly, so their hooks fire and their
output is a fresh tensor, copies the span, the F0 and the carry into the
buffers and replays the graph: one launch where the body enqueues ~220.
Every other chunk (on the CPU, over a mesh, the tail flush, a batch or
shape `warm` did not capture) runs the same body eagerly, with the same
output bit for bit.  Nothing is captured in `synth` or `stream`.  A
replayed chunk's audio lives in the graph's buffer until that shape is
replayed again, which chunks of every stream on the synthesizer share:
`stream` reads it back before it yields, `synth` copies it into its output
in stream order, and the carry is handed out as a copy.
`synth` keeps the carry on the device in fp64, so it reads back only the
finished audio; `stream` reads back each chunk's audio as it yields it;
`synth_scan` reads back once at the end.  Under a profiler a live chunk's
enqueue and readback are the spans `mbexwn.stream.enqueue` and
`mbexwn.stream.readback`, and a graph's launch inside the enqueue is
`mbexwn.stream.replay`; none stays open while `stream` yields.  A replay
runs no Python, so the model-stage spans of the captured part are not
recorded then: its device time falls under the replay span.

The carries and offsets come from the F0 the model synthesises with: the
F0 net on the mel as the model sees it, RMS-normalised where the model
normalises (`normalize_rms_from_mell`, as all three registry models do),
and that F0 is handed to the synthesis, so the net runs once a chunk.  Here
the port departs from the JAX package, which predicts the carry's F0 from
the mel as given: for a normalising model that is not the contour its
oscillator integrates, and its chunked output then departs from one-shot
(by more than 1e-2 rel-RMS, tests/test_torch_streaming.py); for a model
that does not normalise the two are the same computation.  Noise is drawn
per chunk call from a generator seeded 0 (a captured chunk holds that
draw), so chunked output equals one-shot output only with the noise
channel off (sigma 0).

Over a mesh (`parallel.mesh.make_mesh`), `synth_batched` runs its uniform
middle chunk group sequence-parallel: that group's rows (chunks x B) are
split into contiguous shards, one per data row of the mesh, each
synthesised by that row's replica of the model, all enqueued before any is
read back.  A mesh with a "model" axis is taken as `BatchSynthesizer` takes
it: each row's replica is placed on the row's model devices
(`parallel.mesh.replicate`), so the WaveNet stacks of a model built with
`MBEXWN_TP_AXIS=model` split their channels over them and the others stay
whole.
A group whose row count is not a multiple of the mesh's data axis (the
edge chunks) stays on the first device, as in the JAX package.  The F0,
the carries and the offsets are computed once on the first device, before
the split, and each shard takes its rows of them, and of the noise drawn
for the whole group there, so the mesh changes where a chunk is
synthesised and nothing of what it is given.  `synth`, `synth_scan` and
`stream` run on the first row's replica (sharded too, over a model
axis).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from ..nn.wavenet import WaveNetAE
from ..observability import STREAM_ENQUEUE, STREAM_READBACK, STREAM_REPLAY, span
from ..ops.oscillator import phase_velocity
from ..ops.padding import pad1d
from ..ops.precision import exact_fp32
from ..platform import resolve_device
from .mesh import Mesh, replicate, shard_bounds


def _phase_increment(f0: torch.Tensor, rate: float) -> torch.Tensor:
    """(B, T) F0 -> (B,) fp64: the phase (cycles, not wrapped) the oscillator
    integrates over it, the sum of its own fp32 increments."""
    return phase_velocity(f0, rate).double().sum(dim=1)


def _phase_offset(carry: torch.Tensor, f0_left: torch.Tensor, rate: float) -> torch.Tensor:
    """A chunk's `phase_offset` (B,) fp32: the carry (B,) fp64, the phase
    (mod 1) just before its first interior sample, less what the oscillator
    integrates over its left halo's F0 (B, n), mod 1 in fp64."""
    return torch.remainder(carry - _phase_increment(f0_left, rate), 1.0).float()


def _phase_carry(carry: torch.Tensor, f0_inner: torch.Tensor, rate: float) -> torch.Tensor:
    """The carry (B,) fp64 past a chunk's interior F0 (B, n)."""
    return torch.remainder(carry + _phase_increment(f0_inner, rate), 1.0)


@dataclass
class _ChunkGraph:
    """One chunk shape's captured program: the graph, its static inputs
    (mel span (B, span, C), F0 (B, span * stp), carry (B,) fp64), the noise
    it holds, and its outputs (audio (B, inner * hop), the carry at t1)."""
    graph: "torch.cuda.CUDAGraph"
    mel: torch.Tensor
    f0: torch.Tensor
    carry: torch.Tensor
    noise: Optional[torch.Tensor]
    audio: torch.Tensor
    carry_out: torch.Tensor


class StreamingSynthesizer:
    def __init__(self, model: torch.nn.Module, chunk_frames: int = 256, halo_frames: int = 40,
                 halo_right: Optional[int] = None, device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        """model: a `PaNWaveNet` with its weights (moved to `device`).
        halo_right: lookahead halo in mel frames (defaults to halo_frames).
        With a force_causal model the receptive field extends only into the
        past, so halo_right can drop to the lookahead the conditioning
        interpolation and the STFT overlap need (2 frames): live synthesis
        then has an algorithmic latency of chunk_frames + halo_right frames.
        mesh: `synth_batched` splits its uniform chunk group over the mesh's
        data rows; everything else runs on its first row (`device` is then
        not read).  Each row's replica is placed on the row's model devices,
        as the JAX package constrains only the chunk batch, over "data"."""
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.first
        if not model.streamable:
            raise ValueError(f"StreamingSynthesizer: a {type(model).__name__} model has no chunked form (it is "
                             "non-causal and carries no state from chunk to chunk); synthesise it whole with "
                             "MELInverter or serving.PipelinedSynthesizer")
        self.replicas = {self.device: model.to(self.device)} if mesh is None else replicate(model, mesh)
        self.model = self.replicas[self.device]
        self.chunk_frames = chunk_frames
        self.halo_frames = halo_frames
        self.halo_right = halo_frames if halo_right is None else halo_right
        blk = self.model.block
        self.stp = blk.spect_to_pulse_upsampling_factor
        self.hop = blk.spect_hop_size
        self.osc_rate = blk.wavetable.sample_rate  # the rate the oscillator integrates F0 at
        self.programs: Set[tuple] = set()
        self._stacks = [m for m in self.model.modules() if isinstance(m, WaveNetAE)]
        self._state = list(itertools.chain(self.model.parameters(), self.model.buffers()))
        self._graphs: Dict[tuple, _ChunkGraph] = {}
        self._pool = self._capture_stream = None
        self.replays = 0  # chunks that replayed a captured graph

    # ---------------------------------------------------------------- pieces

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    @exact_fp32()
    @torch.inference_mode()
    def _one_shot(self, mell: np.ndarray) -> np.ndarray:
        """A signal no longer than one chunk and its halo: one synthesis."""
        return self.model.infer(self._to_device(mell), synth_length=mell.shape[1] * self.hop).cpu().numpy()

    def _model_f0(self, mel: torch.Tensor) -> torch.Tensor:
        """The F0 contour the model synthesises `mel` (B, T, C) with: the F0
        net on the mel as the model sees it, RMS-normalised where it
        normalises (`PaNWaveNet.prepare_mel`, as `infer` runs it)."""
        mel, _ = self.model.prepare_mel(mel.contiguous())
        return self.model.block.generate_f0(mel)

    def _body(self, mel_span: torch.Tensor, f0: torch.Tensor, carry: torch.Tensor, left: int, inner: int,
              noise: Optional[torch.Tensor] = None):
        """The chunk program after the F0 contour, eager or under capture:
        mel span (B, span, C), its F0 (B, span * stp), the carry (B,) fp64,
        the phase (mod 1) just before frame t0, and the noise (None: the
        model draws it) -> (audio of [t0, t1) (B, inner * hop), the carry at
        t1)."""
        stp, hop, rate = self.stp, self.hop, self.osc_rate
        offset = _phase_offset(carry, f0[:, : left * stp], rate)
        y = self.model.infer(mel_span, synth_length=mel_span.shape[1] * hop, F0=f0, phase_offset=offset,
                             noise=noise)
        carry = _phase_carry(carry, f0[:, left * stp: (left + inner) * stp], rate)
        return y[:, left * hop: (left + inner) * hop], carry

    def _graph_key(self, mel_span: torch.Tensor, left: int, inner: int) -> tuple:
        """What a captured chunk program holds fixed: the shape, the dtype,
        the WaveNet stacks' routes (the int8 mode is read at call time), the
        device, and the versions of the model's weights (a weight changed in
        place, as `load_state_dict` changes it, is another key)."""
        B, length = mel_span.shape[:2]
        return (B, length, left, inner, mel_span.dtype, tuple(m.route() for m in self._stacks), self.device,
                tuple(t._version for t in self._state))

    def _graphs_apply(self) -> bool:
        """Graphs run on a CUDA device without a mesh (a mesh's tensor
        parallelism reduces across devices)."""
        return self.device.type == "cuda" and self.mesh is None

    def _graph_for(self, mel_span: torch.Tensor, left: int, inner: int) -> Optional[_ChunkGraph]:
        """The graph `warm` captured for this chunk's key, where graphs
        apply; else None and the chunk runs eagerly."""
        if not self._graphs or not self._graphs_apply():
            return None
        return self._graphs.get(self._graph_key(mel_span, left, inner))

    @exact_fp32()
    @torch.inference_mode()
    def _capture(self, B: int, length: int, left: int, inner: int) -> None:
        """Capture the chunk program of one shape as a CUDA graph into the
        synthesizer's pool, after one run of it on the capture stream (its
        first use of that stream's library handles and workspaces)."""
        dev = self.device
        mel = torch.full((B, length, self.model.mel_channels), -10.0, dtype=torch.float32, device=dev)
        key = self._graph_key(mel, left, inner)
        if key in self._graphs:
            return
        if self._pool is None:
            self._pool, self._capture_stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        f0 = self._model_f0(mel)
        carry = torch.zeros((B,), dtype=torch.float64, device=dev)
        noise = self.model.noise(B, length, dev)
        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body(mel, f0, carry, left, inner, noise)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            audio, carry_out = self._body(mel, f0, carry, left, inner, noise)
        self._graphs[key] = _ChunkGraph(graph, mel, f0, carry, noise, audio, carry_out)

    @exact_fp32()
    @torch.inference_mode()
    def _chunk(self, mel_span: torch.Tensor, carry: torch.Tensor, left: int, inner: int):
        """The chunk program: mel span (B, span, C) on the host or the device
        and the carry (B,) fp64 on the device, the phase (mod 1) just before
        frame t0 -> (audio of [t0, t1) (B, inner * hop), the carry at t1).
        Enqueued, not waited for.  A captured shape's audio is the graph's
        buffer, valid until that shape is replayed again."""
        self.programs.add((mel_span.shape[1], left, inner))
        g = self._graph_for(mel_span, left, inner)
        if g is None:
            mel_span = mel_span.to(self.device).contiguous()
            return self._body(mel_span, self._model_f0(mel_span), carry, left, inner)
        g.mel.copy_(mel_span)
        g.f0.copy_(self._model_f0(g.mel))
        g.carry.copy_(carry)
        with span(STREAM_REPLAY):
            g.graph.replay()
        self.replays += 1
        return g.audio, g.carry_out.clone()

    def _bounds(self, T: int) -> List[Tuple[int, int, int, int]]:
        """(t0, t1, lo, hi) of every chunk: [t0, t1) synthesised on [lo, hi)."""
        c, h, hr = self.chunk_frames, self.halo_frames, self.halo_right
        bounds, t0 = [], 0
        while t0 < T:
            t1 = min(t0 + c, T)
            bounds.append((t0, t1, max(0, t0 - h), min(T, t1 + hr)))
            t0 = t1
        return bounds

    # ------------------------------------------------------------ long form

    def synth(self, mell: np.ndarray) -> np.ndarray:
        """(B, T, C) log-mel -> (B, T * hop) waveform, chunk after chunk."""
        B, T, _ = mell.shape
        if T <= self.chunk_frames + self.halo_frames:
            return self._one_shot(mell)
        mel = self._to_device(mell)
        carry = torch.zeros((B,), dtype=torch.float64, device=self.device)
        out = torch.empty((B, T * self.hop), dtype=torch.float32, device=self.device)
        for t0, t1, lo, hi in self._bounds(T):
            audio, carry = self._chunk(mel[:, lo:hi], carry, t0 - lo, t1 - t0)
            out[:, t0 * self.hop: t1 * self.hop] = audio  # before a replay of the shape overwrites it
        return out.cpu().numpy()

    @exact_fp32()
    @torch.inference_mode()
    def synth_batched(self, mell: np.ndarray) -> np.ndarray:
        """Every chunk in one batched call per chunk shape instead of one after
        another: the chunks of each (span, left, inner) shape form one device
        batch of B * n_chunks rows.  One F0 pass per group gives every
        chunk's carry (fp64 mod 1, on the device) and offset, and the
        synthesis takes that F0 as given, so the F0 net runs once a chunk."""
        B, T, C = mell.shape
        if T <= self.chunk_frames + self.halo_frames:
            return self._one_shot(mell)
        stp, hop = self.stp, self.hop
        bounds = self._bounds(T)
        groups: Dict[Tuple[int, int, int], list] = {}
        for idx, (t0, t1, lo, hi) in enumerate(bounds):
            groups.setdefault((hi - lo, t0 - lo, t1 - t0), []).append(idx)

        # the F0 of each group, then each chunk's offset and the carry past it, in chunk order
        inputs, f0_of = {}, [None] * len(bounds)
        for (span, left, inner), idxs in groups.items():
            mel_spans = self._to_device(np.stack([mell[:, bounds[i][2]: bounds[i][3]] for i in idxs], axis=0)
                                        .reshape(-1, span, C))
            self.programs.add(("f0", span))
            f0 = self._model_f0(mel_spans)
            for i, f0_chunk in zip(idxs, f0.reshape(len(idxs), B, -1)):
                f0_of[i] = f0_chunk
            inputs[(span, left, inner)] = (mel_spans, f0)
        carry = torch.zeros((B,), dtype=torch.float64, device=self.device)
        offsets = []
        for (t0, t1, lo, _), f0 in zip(bounds, f0_of):
            left, inner = t0 - lo, t1 - t0
            offsets.append(_phase_offset(carry, f0[:, : left * stp], self.osc_rate))
            carry = _phase_carry(carry, f0[:, left * stp: (left + inner) * stp], self.osc_rate)

        out = torch.empty((B, T * hop), dtype=torch.float32, device=self.device)
        ys = {}
        for (span, left, inner), idxs in groups.items():
            self.programs.add(("batched", span, left, inner))
            mel_spans, f0 = inputs[(span, left, inner)]
            ys[(span, left, inner)] = self._synth_rows(mel_spans, f0, torch.cat([offsets[i] for i in idxs]),
                                                       span * hop)
        for (span, left, inner), idxs in groups.items():
            y = torch.cat([part.to(self.device) for part in ys[(span, left, inner)]])
            y = y[:, left * hop: (left + inner) * hop].reshape(len(idxs), B, inner * hop)
            for row, i in enumerate(idxs):
                out[:, bounds[i][0] * hop: bounds[i][1] * hop] = y[row]
        return out.cpu().numpy()

    def _synth_rows(self, mel_spans: torch.Tensor, f0: torch.Tensor, offsets: torch.Tensor,
                    synth_length: int) -> List[torch.Tensor]:
        """One chunk group's synthesis, enqueued, as the audio of its shards
        in row order: on the first device, or split over the mesh when its
        rows divide evenly, with the noise the model would draw for the
        whole group on the first device."""
        n = 1 if self.mesh is None else self.mesh.shape["data"]
        if n == 1 or mel_spans.shape[0] % n:
            return [self.model.infer(mel_spans, synth_length=synth_length, F0=f0, phase_offset=offsets)]
        noise = self.model.noise(mel_spans.shape[0], mel_spans.shape[1], self.device)
        shards = [(dev, [t[lo:hi].to(dev) for t in (mel_spans, f0, offsets)]
                   + [None if noise is None else noise[lo:hi].to(dev)])
                  for dev, (lo, hi) in zip(self.mesh.devices, shard_bounds(mel_spans.shape[0], n))]
        return [self.replicas[dev].infer(m, synth_length=synth_length, F0=f, phase_offset=o, noise=nz)
                for dev, (m, f, o, nz) in shards]

    @exact_fp32()
    @torch.inference_mode()
    def synth_scan(self, mell: np.ndarray) -> np.ndarray:
        """(B, T, C) log-mel -> (B, T * hop) waveform, every chunk enqueued back
        to back with no readback until the end (the JAX package runs this
        loop as one lax.scan program).

        All chunks use one uniform [halo_frames | chunk | halo_right] span:
        the mel is edge-replicated into the outer halos and to a whole
        number of chunks, so the first and last `halo_frames` of output see
        replicated context where the one-shot program sees the signal
        boundary.  One full-length F0 pass fixes every chunk's start phase
        from the contour the one-shot program integrates, and every chunk
        synthesises against that contour (sliced), so its phase integral is
        the one-shot phase.  Each chunk is the chunk program's body, its
        interior the contour's next c frames."""
        B, T, _ = mell.shape
        c, h, hr = self.chunk_frames, self.halo_frames, self.halo_right
        if T <= c + h:
            return self._one_shot(mell)
        stp, hop = self.stp, self.hop
        n_chunks = -(-T // c)
        span = c + h + hr
        self.programs.add(("scan", n_chunks, B))
        mel_halo = self._to_device(np.pad(mell, ((0, 0), (h, n_chunks * c - T + hr), (0, 0)), mode="edge"))
        f0_full = self._model_f0(self._to_device(mell))
        f0_haloed = pad1d(f0_full[:, :, None], h * stp, (n_chunks * c + hr) * stp - f0_full.shape[1],
                          "EDGE")[:, :, 0]
        carry = torch.zeros((B,), dtype=torch.float64, device=self.device)
        out = torch.empty((B, n_chunks * c * hop), dtype=torch.float32, device=self.device)
        for i in range(n_chunks):
            mel_span = mel_halo[:, i * c: i * c + span].contiguous()
            f0_span = f0_haloed[:, i * c * stp: (i * c + span) * stp].contiguous()
            y, carry = self._body(mel_span, f0_span, carry, h, c)
            out[:, i * c * hop: (i + 1) * c * hop] = y
        return out[:, : T * hop].cpu().numpy()

    # ------------------------------------------------------------------ live

    def warm(self, batch_size: int = 1) -> None:
        """Run every chunk shape stream() and synth() meet in the left-halo
        ramp (the left context grows min(h, k * c) until it reaches h) once
        on the device at `batch_size` rows, so live synthesis meets no
        first-call cost at its first audio.  On a CUDA device without a
        mesh, then capture each shape's chunk program as a CUDA graph, which
        every later chunk of that shape and batch replays."""
        c, h, hr = self.chunk_frames, self.halo_frames, self.halo_right
        C = self.model.mel_channels
        carry = torch.zeros((batch_size,), dtype=torch.float64, device=self.device)
        for left in sorted({min(h, k * c) for k in range(-(-h // c) + 1)}):
            mel = torch.full((batch_size, left + c + hr, C), -10.0, dtype=torch.float32, device=self.device)
            self._chunk(mel, carry, left, c)
            if self._graphs_apply():
                self._capture(batch_size, left + c + hr, left, c)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stream(self, frames_iter: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Live synthesis: consume (B, n, C) mel-frame slabs and yield
        (B, chunk_frames * hop) audio slabs as soon as they can be computed.

        A chunk's audio is emitted once `halo_right` frames beyond its end
        have arrived, so the algorithmic latency is chunk_frames +
        halo_right mel frames (12.5 ms a frame at 24 kHz and hop 300).  Once
        the iterator is exhausted the tail is flushed with the lookahead cut
        at the signal end, the boundary the one-shot program sees, so the
        output equals synth()'s chunk for chunk, whatever the slab sizes."""
        c, h, hr = self.chunk_frames, self.halo_frames, self.halo_right
        buf = None  # frames received and still needed; buf[:, 0] is frame buf_start
        buf_start = 0
        t0 = 0  # the next chunk starts at this frame
        carry = None

        def emit(mel_span, left, inner, carry):
            # the spans close before the caller yields: the consumer's work falls under neither
            with span(STREAM_ENQUEUE):
                mel_span = torch.from_numpy(np.ascontiguousarray(mel_span, dtype=np.float32))
                audio, carry = self._chunk(mel_span, carry, left, inner)
            with span(STREAM_READBACK):
                return audio.cpu().numpy(), carry

        for slab in frames_iter:
            slab = np.asarray(slab)
            if buf is None:
                buf = slab
                carry = torch.zeros((slab.shape[0],), dtype=torch.float64, device=self.device)
            else:
                buf = np.concatenate([buf, slab], axis=1)
            while buf_start + buf.shape[1] >= t0 + c + hr:
                lo = max(0, t0 - h)
                audio, carry = emit(buf[:, lo - buf_start: t0 + c + hr - buf_start], t0 - lo, c, carry)
                yield audio
                t0 += c
                new_lo = max(0, t0 - h)
                buf = buf[:, new_lo - buf_start:]
                buf_start = new_lo
        if buf is None:
            return
        total = buf_start + buf.shape[1]
        while t0 < total:
            inner = min(c, total - t0)
            lo = max(0, t0 - h)
            hi = min(total, t0 + inner + hr)
            audio, carry = emit(buf[:, lo - buf_start: hi - buf_start], t0 - lo, inner, carry)
            yield audio
            t0 += inner
