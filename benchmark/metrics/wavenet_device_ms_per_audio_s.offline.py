"""Device ms launched under the program's `mbexwn.model.wavenet.*` spans (one
a WaveNet block: K1 and the copies around it) in the traced slice, per
requested audio second completed in it."""
from _spans import WAVENET, device_ms_per_audio_s


def read(run):
    return device_ms_per_audio_s(run, lambda name: name.startswith(WAVENET))
