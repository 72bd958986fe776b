"""The models, and the contract the consumers at the model's edge
(`MELInverter`, `serving`, `parallel`, `compat.export`) hold them to:

- `infer(spect (B, T, C) log-mel, synth_length=0, noise=None, ...)` ->
  (B, synth_length) audio, the mel extended by its last frame where short
  and RMS-normalised where the model normalises (`PaNWaveNet.prepare_mel`);
- `noise_shape(batch, T_mel)`: `infer`'s `noise`; without it the model draws
  its own from a generator seeded 0 on the mel's device.  `PaNWaveNet.noise
  (batch, T_mel, device)` is that draw (None with the noise channel off),
  for callers that hold or split it;
- `spect_hop_size`, `mel_channels`, `sample_rate`, and `streamable` (whether
  `parallel.StreamingSynthesizer` can chunk it: not WaveGlow's flows);
- `factory.load_model(id or directory)` -> (model, hparams), the one loader
  of either family; each model loads its flat JAX-layout params itself
  (`load_jax_params`).
"""
from .factory import create_model, create_registry_model, load_model
from .mbexwn import MBExWN
from .pan_wavenet import NormMelComponents, PaNWaveNet
from .waveglow import WaveGlow

__all__ = ["create_model", "create_registry_model", "load_model", "MBExWN", "NormMelComponents", "PaNWaveNet",
           "WaveGlow"]
