"""Device ms launched under the program's WaveGlow spans outside the WNs
(`mbexwn.model.waveglow.upsample`: the upsampler, its trim, the unfold and
the cast; `mbexwn.model.waveglow.coupling`: the noise, each flow's coupling
inverse, W^-1 and early z) in the traced slice, per requested audio second
completed in it."""
from _spans import device_ms_per_audio_s

SPANS = ("mbexwn.model.waveglow.upsample", "mbexwn.model.waveglow.coupling")


def read(run):
    return device_ms_per_audio_s(run, lambda name: name in SPANS)
