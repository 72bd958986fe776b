"""Offline rendering of WaveGlow: the offline runner's closed loop through
`PipelinedSynthesizer.stream` (runners/offline.py) on a WaveGlow model
directory.

Set-up writes the configuration's seeded weights into the system's
temporary directory, or reuses them (reference/waveglow_ref.py
`model_dir`), and loads them with `MELInverter(dir)`.  WaveGlow has no F0
stage: the check holds the model's first stage, the upsampled conditioning,
on its own in the `f0_rel` slot (a hook on the program's upsampler, kept for
the compared groups as `F0Tap` keeps the F0 net's output), and the audio
against the reference's fp32 synthesis from the same mel with the same z
(the model's seeded draw for the group: a generator seeded 0 on the device,
as the reference draws it).
"""
from __future__ import annotations

import numpy as np
import torch

import generator as gen
from reference.mbexwn_ref import edge_pad
from reference.waveglow_ref import Reference, model_dir
from runners.base import F0Tap
from runners.offline import Runner as OfflineRunner


class UpsampleTap(F0Tap):
    """`F0Tap` on the program's upsampler (`model.upsample`): its output
    (B, T * hop / n_group, n_mel * n_group), fp32, for the calls `want` selects."""

    def __init__(self, model: torch.nn.Module):
        self.calls = 0
        self.want = lambda k: False
        self.kept = {}
        self.handle = model.upsample.register_forward_hook(self._hook)


class Runner(OfflineRunner):
    def setup(self):
        from mbexwn_vocoder_torch.mel_inverter import MELInverter
        from mbexwn_vocoder_torch.serving import PipelinedSynthesizer

        mix, seed = self.mix, self.ctx.seed
        lo, hi = mix["frames"]
        self.lengths = gen.stratified_lengths(lo, hi, mix["pool"], gen.rng_for(seed, 1))
        self.pool = gen.mel_pool(self.lengths, self.n_mels, seed, 2)
        self.batch, self.bucket = mix["batch"], mix["bucket"]
        self.model_path = model_dir(self.config)
        self.inv = MELInverter(str(self.model_path), device=self.device)
        self.model = self.inv.model
        self.synth = PipelinedSynthesizer(self.model, depth=mix["depth"], batch=self.batch, device=self.device)
        if {self.synth._bucket_len(T) for T in self.lengths} != {self.bucket}:
            raise ValueError(f"the mix's lengths {lo}-{hi} do not all fall in bucket {self.bucket}")
        # warm the one shape the window runs: full groups of this bucket
        for _ in range(2):
            for _ in self.synth.stream(m[0] for m in self.pool[: self.batch * mix["depth"]]):
                pass
        self.sync()
        self.tap = UpsampleTap(self.model)
        lo_g, hi_g = mix["check_group_range"]
        rng = gen.rng_for(seed, 3)
        self.check_groups = sorted(int(g) for g in rng.choice(np.arange(lo_g, hi_g), mix["check_groups"],
                                                              replace=False))

    def compare(self, tally):
        ref = Reference(self.config, self.model_path, self.device)
        stand_in = Reference(self.config, self.model_path, self.device, mode="fp8") if self.ctx.control == "ref8" else None
        B, T_pad, hop = self.batch, self.bucket, self.hop
        G = self.config["waveglow_config"]["n_group"]
        for g in self.check_groups:
            rows = [g * B + r for r in range(B)]
            if g not in self.f0_out or not all(k in self.kept for k in rows):
                continue
            mel = torch.from_numpy(np.concatenate([edge_pad(self.utterance(k)[0], T_pad) for k in rows]))
            mel = mel.to(self.device)
            up_ref = ref.upsampled(mel).transpose(1, 2).cpu()
            up_prog = self.f0_out[g] if stand_in is None else stand_in.upsampled(mel).transpose(1, 2).cpu()
            audio_ref = ref.synth(mel, T_pad * hop).cpu().numpy()
            prog = None if stand_in is None else stand_in.synth(mel, T_pad * hop).cpu().numpy()
            for r, k in enumerate(rows):
                n = self.utterance(k)[1]
                y = self.kept[k] if prog is None else prog[r, : n * hop]
                tally.add(up_prog[r, : n * hop // G], up_ref[r, : n * hop // G], y, audio_ref[r, : n * hop])
