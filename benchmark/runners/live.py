"""Live synthesis: concurrent sessions of `StreamingSynthesizer.stream`.

`sessions` live streams share one model and one thread, each its own
`stream()` generator over a seeded utterance of `utterance_s` seconds,
looped.  Each receives `slab_frames` mel frames every slab period (real
time: 12.5 ms a frame), the sessions' phases spread evenly over a chunk
period.  A chunk (`chunk_frames`, `halo_frames` of left context,
`halo_right` of lookahead) is computed as soon as its last lookahead frame
is in; it is due when that frame was due, and its latency runs from then
to its audio on the host.  Every session is past its left-halo ramp in
set-up; the real-time schedule starts `lead_s` before the window.
`chunk_p95_ms` is the 95th percentile over every chunk of every session
due in the window.
"""
from __future__ import annotations

import heapq
import time
from collections import deque

import numpy as np
import torch

import generator as gen
from runners.base import DRAIN_S, BaseRunner, F0Tap, p95_ms, sleep_until


class Runner(BaseRunner):
    def setup(self):
        from mbexwn_vocoder_torch.models.factory import create_registry_model
        from mbexwn_vocoder_torch.parallel.streaming import StreamingSynthesizer

        mix, seed = self.mix, self.ctx.seed
        self.N = mix["sessions"]
        self.c, self.h, self.hr, self.slab = (mix["chunk_frames"], mix["halo_frames"], mix["halo_right"],
                                              mix["slab_frames"])
        if self.c % self.slab or self.hr % self.slab:
            raise ValueError("chunk_frames and halo_right must be whole numbers of slabs")
        self.frame_s = self.hop / self.sr
        n_frames = int(round(mix["utterance_s"] / self.frame_s))
        self.mels = [gen.make_mel(n_frames, self.n_mels, gen.rng_for(seed, 2, s))[0] for s in range(self.N)]
        model = create_registry_model(self.config["model_id"], **mix.get("mbexwn_overrides", {}))
        self.ss = StreamingSynthesizer(model, chunk_frames=self.c, halo_frames=self.h, halo_right=self.hr,
                                       device=self.device)
        self.ss.warm()
        self.tap = F0Tap(self.ss.model)
        rng = gen.rng_for(seed, 3)
        self.check_sessions = sorted(int(s) for s in rng.choice(self.N, mix["check_sessions"], replace=False))
        self.current = None
        self.tap.reset(lambda call: self.current in self.check_sessions)
        self.calls = {s: [] for s in self.check_sessions}  # tap call index of each chunk of a checked session
        # one stream per session, fed slab by slab, past the left-halo ramp
        self.queues = [deque() for _ in range(self.N)]
        self.streams = [self.ss.stream(self._feeder(s)) for s in range(self.N)]
        self.next_slab = [0] * self.N
        self.chunks_done = [0] * self.N
        self.ramp = -(-self.h // self.c) + 1
        for s in range(self.N):
            for _ in range(self.ramp):
                self._push_until_chunk(s)
                self._chunk(s)
        self.sync()

    def _feeder(self, s):
        q = self.queues[s]
        while True:
            yield q.popleft()

    def _slab(self, s, j):
        mel, n = self.mels[s], self.mels[s].shape[0]
        idx = np.arange(j * self.slab, (j + 1) * self.slab) % n
        return mel[idx][None]

    def _last_slab_of(self, k):
        """The slab that completes chunk k's lookahead."""
        return ((k + 1) * self.c + self.hr) // self.slab - 1

    def _push_until_chunk(self, s):
        while self.next_slab[s] <= self._last_slab_of(self.chunks_done[s]):
            self.queues[s].append(self._slab(s, self.next_slab[s]))
            self.next_slab[s] += 1

    def _chunk(self, s):
        self.current = s
        if s in self.calls:
            self.calls[s].append(self.tap.calls)
        audio = next(self.streams[s])
        self.current = None
        self.chunks_done[s] += 1
        return audio

    def start(self, tracer):
        self.tracer = tracer
        self.t_rt = time.perf_counter()
        self.window_start = self.t_rt + self.mix["lead_s"]
        tracer.arm(self.window_start)

    def run_window(self, seconds):
        self.window_end = self.window_start + seconds
        slab_s = self.slab * self.frame_s
        chunk_s = self.c * self.frame_s
        j0 = list(self.next_slab)  # the first slab each session receives in real time
        offsets = [s * chunk_s / self.N for s in range(self.N)]
        heap = [(self.t_rt + offsets[s], s) for s in range(self.N)]
        heapq.heapify(heap)
        self.records = []  # (session, chunk, due, done)
        self.kept = {s: {} for s in self.check_sessions}
        while heap:
            due, s = heapq.heappop(heap)
            if due >= self.window_end:
                continue
            sleep_until(due)
            self.tracer.poll()
            j = self.next_slab[s]
            self.queues[s].append(self._slab(s, j))
            self.next_slab[s] += 1
            if j == self._last_slab_of(self.chunks_done[s]):
                k = self.chunks_done[s]
                audio = self._chunk(s)
                now = time.perf_counter()
                self.records.append((s, k, due, now))
                if s in self.kept and due >= self.window_start:
                    self.kept[s][k] = audio[0]
                if now > self.window_end + DRAIN_S:
                    break
            heapq.heappush(heap, (self.t_rt + offsets[s] + (self.next_slab[s] - j0[s]) * slab_s, s))
        self.j0 = j0

    def _due_in_window(self):
        return [r for r in self.records if self.window_start <= r[2] < self.window_end]

    def finish(self):
        self.t_end = time.perf_counter()
        slab_s = self.slab * self.frame_s
        chunk_s = self.c * self.frame_s
        served = {(s, k) for s, k, _, _ in self._due_in_window()}
        self.unserved = []
        n_due = 0
        for s in range(self.N):
            k = self.ramp
            while True:
                due = self.t_rt + s * chunk_s / self.N + (self._last_slab_of(k) - self.j0[s]) * slab_s
                if due >= self.window_end:
                    break
                if due >= self.window_start:
                    n_due += 1
                    if (s, k) not in served:
                        self.unserved.append(due)
                k += 1
        self.attempted = n_due
        self.missing = self.failed = len(self.unserved)

    def end_to_end(self, seconds):
        lat = [done - due for _, _, due, done in self._due_in_window()]
        lat += [self.t_end - due for due in self.unserved]  # never answered: at least this late
        return {"chunk_p95_ms": p95_ms(lat)}

    def slice_counts(self, t0, t1):
        return {"chunks": sum(1 for r in self.records if t0 <= r[3] < t1)}

    def release(self):
        self.f0_out = self.tap.host()
        self.tap.remove()
        for g in self.streams:
            g.close()
        del self.streams, self.ss
        self.sync()

    def compare(self, tally):
        ref, stand_in = self.references(causal=True)
        c, h, hr, hop, stp = self.c, self.h, self.hr, self.hop, ref.stp
        inv_rate = torch.tensor(1.0 / ref.pulse_rate, dtype=torch.float32)
        for s in self.check_sessions:
            if not self.kept[s]:
                continue
            mel_all = self.mels[s]
            carry = 0.0
            f0p, f0r, yp, yr = [], [], [], []
            for k, call in enumerate(self.calls[s]):
                if k > max(self.kept[s]):
                    break
                t0 = k * c
                lo, left = max(0, t0 - h), min(h, t0)
                idx = np.arange(lo, t0 + c + hr) % mel_all.shape[0]
                span = torch.from_numpy(mel_all[idx][None]).to(self.device)
                net_out = self.f0_out[call].to(self.device) if stand_in is None else stand_in.f0_net(span)
                f0 = ref.f0_from_net_output(net_out, span.shape[1])
                inc = (f0.cpu() * inv_rate).double()
                offset = torch.tensor([(carry - float(inc[0, : left * stp].sum())) % 1.0])
                if k in self.kept[s]:
                    audio = ref.synth(span, span.shape[1] * hop, f0=f0, phase_offset=offset.to(self.device))
                    yr.append(audio[0, left * hop: (left + c) * hop].cpu().numpy())
                    if stand_in is None:
                        yp.append(self.kept[s][k])
                    else:
                        a = stand_in.synth(span, span.shape[1] * hop, f0=f0, phase_offset=offset.to(self.device))
                        yp.append(a[0, left * hop: (left + c) * hop].cpu().numpy())
                    f0p.append(f0[0].cpu().numpy())
                    f0r.append(ref.f0_of(span)[0].cpu().numpy())
                carry = (carry + float(inc[0, left * stp: (left + c) * stp].sum())) % 1.0
            if yp:
                tally.add(np.concatenate(f0p), np.concatenate(f0r), np.concatenate(yp), np.concatenate(yr))
