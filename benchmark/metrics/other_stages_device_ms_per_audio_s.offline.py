"""Device ms launched under the program's other model stage spans
(`mbexwn.model.` normmel, f0_net, excitation, post_pqmf, envelope) in the
traced slice, per requested audio second completed in it."""
from _spans import OTHER_STAGES, device_ms_per_audio_s


def read(run):
    return device_ms_per_audio_s(run, lambda name: name in OTHER_STAGES)
