"""Offline rendering: a closed loop through `PipelinedSynthesizer.stream`.

One client keeps the pipeline full: each utterance is handed over as soon
as the stream asks for the next, and groups of `batch` utterances of one
length bucket are dispatched with `depth` groups in flight.  Utterances
are taken in turn from a pool made in set-up; their lengths are spread
evenly over `frames`.  The loop starts `lead_s` before the window.
`audio_s_per_s` is the requested (trimmed) audio whose samples reached the
host inside the window, over the window.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import generator as gen
from runners.base import BaseRunner, F0Tap
from reference.mbexwn_ref import edge_pad


class Runner(BaseRunner):
    def setup(self):
        from mbexwn_vocoder_torch.mel_inverter import MELInverter
        from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

        mix, seed = self.mix, self.ctx.seed
        lo, hi = mix["frames"]
        self.lengths = gen.stratified_lengths(lo, hi, mix["pool"], gen.rng_for(seed, 1))
        self.pool = gen.mel_pool(self.lengths, self.n_mels, seed, 2)
        self.batch, self.bucket = mix["batch"], mix["bucket"]
        self.inv = MELInverter(self.config["model_id"], device=self.device)
        self.model = self.inv.model
        self.synth = PipelinedSynthesizer(self.model, depth=mix["depth"], batch=self.batch, device=self.device)
        if {self.synth._bucket_len(T) for T in self.lengths} != {self.bucket}:
            raise ValueError(f"the mix's lengths {lo}-{hi} do not all fall in bucket {self.bucket}")
        # warm the one shape the window runs: full groups of this bucket
        for _ in range(2):
            for _ in self.synth.stream(m[0] for m in self.pool[: self.batch * mix["depth"]]):
                pass
        self.sync()
        self.tap = F0Tap(self.model)
        # the groups whose answers are compared, drawn from the seed (counted
        # from the loop's start; the lead-in before the window is short)
        lo_g, hi_g = mix["check_group_range"]
        rng = gen.rng_for(seed, 3)
        self.check_groups = sorted(int(g) for g in rng.choice(np.arange(lo_g, hi_g), mix["check_groups"],
                                                              replace=False))

    def start(self, tracer):
        self.tracer = tracer
        self.window_start = time.perf_counter() + self.mix["lead_s"]
        tracer.arm(self.window_start)

    def _feed(self, t_stop):
        i = 0
        while True:
            # stop only at a group boundary, so every group dispatched is full
            if i % self.batch == 0 and time.perf_counter() >= t_stop:
                return
            self.fed += 1
            yield self.pool[i % len(self.pool)][0]
            i += 1

    def utterance(self, k: int):
        return self.pool[k % len(self.pool)], self.lengths[k % len(self.pool)]

    def run_window(self, seconds):
        self.window_end = self.window_start + seconds
        self.fed, self.done_at, self.kept = 0, [], {}
        want = set(self.check_groups)
        self.tap.reset(lambda call: call in want)  # one F0 net call per group, in dispatch order
        for k, y in enumerate(self.synth.stream(self._feed(self.window_end))):
            now = time.perf_counter()
            self.done_at.append(now)
            self.tracer.poll(now)
            if k // self.batch in want:
                self.kept[k] = np.array(y)

    def finish(self):
        self.attempted = self.fed
        self.missing = self.failed = self.fed - len(self.done_at)

    def end_to_end(self, seconds):
        audio = sum(self.utterance(k)[1] * self.hop / self.sr
                    for k, t in enumerate(self.done_at) if self.window_start <= t < self.window_end)
        return {"audio_s_per_s": audio / seconds}

    def slice_counts(self, t0, t1):
        """Requests completed in [t0, t1) and their requested frames."""
        frames = [self.utterance(k)[1] for k, t in enumerate(self.done_at) if t0 <= t < t1]
        return {"requests": len(frames), "frames": frames}

    def release(self):
        self.f0_out = self.tap.host()
        self.tap.remove()
        del self.synth, self.model, self.inv
        self.sync()

    def compare(self, tally):
        ref, stand_in = self.references()
        B, T_pad, hop = self.batch, self.bucket, self.hop
        for g in self.check_groups:
            rows = [g * B + r for r in range(B)]
            if g not in self.f0_out or not all(k in self.kept for k in rows):
                continue
            mel = torch.from_numpy(np.concatenate([edge_pad(self.utterance(k)[0], T_pad) for k in rows]))
            mel = mel.to(self.device)
            net_out = self.f0_out[g].to(self.device) if stand_in is None else stand_in.f0_net(mel)
            f0_prog = ref.f0_from_net_output(net_out, T_pad).cpu()
            f0_ref = ref.f0_of(mel).cpu()
            audio_ref = ref.synth(mel, T_pad * hop, f0_net_output=net_out).cpu().numpy()
            prog = None if stand_in is None else stand_in.synth(mel, T_pad * hop, f0_net_output=net_out).cpu().numpy()
            for r, k in enumerate(rows):
                n = self.utterance(k)[1]
                y = self.kept[k] if prog is None else prog[r, : n * hop]
                tally.add(f0_prog[r, : n * ref.stp], f0_ref[r, : n * ref.stp], y, audio_ref[r, : n * hop])
