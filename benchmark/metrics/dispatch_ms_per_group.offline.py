"""Host ms a dispatch group takes to enqueue: the mean length of the
program's `mbexwn.serving.dispatch` spans in the traced slice (stack,
pinned copy in, the model's enqueue, copy out, event record)."""
from _spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "mbexwn.serving.dispatch")
