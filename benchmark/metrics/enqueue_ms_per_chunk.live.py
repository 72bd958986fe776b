"""Host ms a live chunk takes to enqueue: the mean length of the program's
`mbexwn.stream.enqueue` spans in the traced slice (copy in, carry
arithmetic, the model's op-by-op enqueue)."""
from _spans import mean_host_ms


def read(run):
    return mean_host_ms(run, "mbexwn.stream.enqueue")
