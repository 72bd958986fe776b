"""Share (%) of the live chunks enqueued in the traced slice that replayed a
captured CUDA graph: 100 x the program's `mbexwn.stream.replay` spans over
its `mbexwn.stream.enqueue` spans.  A program that has no replay span
(`observability.STREAM_REPLAY`, the parent of the change that added it)
reads nothing; one that has it and replayed no chunk reads 0."""
import importlib

from _spans import spans_of

ENQUEUE, REPLAY = "mbexwn.stream.enqueue", "mbexwn.stream.replay"


def read(run):
    sp = spans_of(run)
    if sp is None or not sp.host.get(ENQUEUE):
        return None
    observability = importlib.import_module("mbexwn_vocoder_torch.observability")
    if getattr(observability, "STREAM_REPLAY", None) != REPLAY:
        return None
    return 100.0 * len(sp.host.get(REPLAY, [])) / len(sp.host[ENQUEUE])
