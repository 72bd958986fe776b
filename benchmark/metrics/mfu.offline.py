"""The whole synthesis's share (%) of the bf16 peak: the frozen
`counts.synthesis_flops` of the requested (trimmed) frames of every request
completed in the traced slice, over the slice times 989 TFLOP/s.  Padding
to the length bucket is not useful work."""
import counts


def read(run):
    frames = run.runner.slice_counts(run.trace.t0, run.trace.t1).get("frames")
    if not frames or run.trace.window_s <= 0:
        return None
    flops = sum(counts.synthesis_flops(run.config, T)["flops_per_call"] for T in frames)
    return 100.0 * flops / (run.trace.window_s * counts.PEAK_BF16_FLOPS)
