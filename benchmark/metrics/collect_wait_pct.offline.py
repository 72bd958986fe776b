"""Share (%) of the traced slice the host spends waiting on a group's event
(`mbexwn.serving.collect_wait` spans): how far the host runs ahead of the
card; near 0, the host paces."""
from _spans import host_pct


def read(run):
    return host_pct(run, "mbexwn.serving.collect_wait")
