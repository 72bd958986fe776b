"""Share (%) of the traced slice in which the card idles while the host is
inside a `mbexwn.stream.enqueue` span: the idle time that enqueueing a
chunk as one graph launch could remove (the rest is the input's own pace,
or the readback)."""
from _spans import idle_under_ns, spans_of


def read(run):
    sp = spans_of(run)
    if sp is None or not sp.device or "mbexwn.stream.enqueue" not in sp.host or run.trace.window_s <= 0:
        return None
    return 100.0 * idle_under_ns(sp, "mbexwn.stream.enqueue") / 1e9 / run.trace.window_s
