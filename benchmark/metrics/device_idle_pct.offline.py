"""Share (%) of the traced slice in which no kernel, copy or set ran on the
card: 100 x (1 - union of the device's intervals / the slice)."""
from _common import idle_pct


def read(run):
    return idle_pct(run)
