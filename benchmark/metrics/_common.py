"""What the per-layer readers share (not a metric: the harness reads only
the files that BENCHMARK.json names)."""
from __future__ import annotations

import counts


def idle_pct(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.n_device == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def per_unit(run, count_key):
    """Host launch calls in the traced slice per request or chunk completed in it."""
    n = run.runner.slice_counts(run.trace.t0, run.trace.t1).get(count_key, 0)
    if not n or not run.trace.launch_calls:
        return None
    return run.trace.launch_calls / n


def op_roofline(run, op, bound_seconds):
    """Share (%) of the device time under `op` that its calls' roofline bound
    (summed from each call's input shapes) accounts for."""
    t = run.trace
    calls = t.op_shapes.get(op, [])
    busy = t.op_device_s.get(op, 0.0)
    if not calls or busy <= 0:
        return None
    return 100.0 * sum(bound_seconds(shapes) for shapes in calls) / busy


def k1_bound(shapes):
    """One `mbexwn::wavenet_stack` call: x (B, T, C), cond (B, T, 2C), w_dil (n_layers, 2C, 3, Cp)."""
    (B, T, _), cond, w_dil = shapes[0], shapes[1], shapes[2]
    return counts.roofline_seconds(*counts.k1_work(B, T, cond[-1] // 2, w_dil[0]))


def k2_bound(shapes):
    """One `mbexwn::oscillate` call: f0 (B, T), tables (n_wavetable, n_grid)."""
    (B, T), (n_wt, n_grid) = shapes[0], shapes[1]
    return counts.roofline_seconds(0.0, counts.k2_bytes(B, T, n_wt, n_grid))
