"""Host ms of a live chunk's blocking readback: the mean length of the
program's `mbexwn.stream.readback` spans in the traced slice."""
from _spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "mbexwn.stream.readback")
