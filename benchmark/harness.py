"""One run of one benchmark cell: set-up, the timed window, the check.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`); the mix names its runner
(`benchmark/runners/<runner>.py`), which runs the program's entry point.
Per-layer metrics are read by `benchmark/metrics/<name>.py`, the limits
of the check are `benchmark/limits/<workload>.json`: a new cell, mix,
configuration or metric is new files and entries, no edit.

The last line on standard output is the result, one JSON object; the
numbers compared are the last lines on standard error.  A run with no card,
with fewer cards than the cell asks for, without the program beside the
benchmark, or with JAX loaded after the window prints no result and exits
non-zero.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
PROGRAM = "mbexwn_vocoder_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mbexwn_vocoder_tpu")
CACHE = ROOT / ".bench_cache"


class RunError(SystemExit):
    """Ends the run without a result line."""

    def __init__(self, message: str, code: int = 2):
        print(f"benchmark: {message}", file=sys.stderr, flush=True)
        super().__init__(code)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"no file {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"bench_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path, what: str):
    if not path.is_file():
        raise RunError(f"no {what} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def resolve_cell(workload: str, spec_path: Path = ROOT / "BENCHMARK.json"):
    """(cell entry, configuration dict, mix dict, end-to-end metric entries,
    per-layer metric entries) of a workload name; unknown names raise."""
    spec = load_json(spec_path, "benchmark")
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = load_json(BENCH / "configs" / f"{cell['config']}.json", "configuration")
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json", "traffic")
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m["workloads"] or ("workloads" not in m and m["moves"] in reported)]
    return cell, config, mix, e2e, per_layer


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err}"


def pin_caches() -> None:
    """Every build and kernel cache the program or PyTorch may write goes to a
    fixed directory inside the checkout (the kernels' own build directory,
    mbexwn_vocoder_torch/_build/, already is)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the check's own runs: the control (the program's int8 mode, or the
    # reference in fp8 put in the program's place), and a CPU run for tests
    p.add_argument("--control", choices=("", "int8", "ref8"), default="")
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    # a sweep's runs: a traffic parameter set for this run (KEY=JSON), never a cell's
    p.add_argument("--set", action="append", default=[], help=argparse.SUPPRESS)
    return p.parse_args(argv)


# switches of the program that would change what is measured; a run sets
# them itself (the int8 control) and puts them back afterwards
PROGRAM_ENV = ("MBEXWN_WN_QUANT", "MBEXWN_WN_DTYPE", "MBEXWN_SUBNET_DTYPE", "MBEXWN_TP_AXIS", "MBEXWN_PLATFORM")


def main(argv=None, t_process: float = None, spec_path: Path = ROOT / "BENCHMARK.json", mix_override=None):
    """One run as the configuration states it, whatever the caller's environment."""
    saved = {k: os.environ.pop(k) for k in PROGRAM_ENV if k in os.environ}
    try:
        return _run(argv, t_process, spec_path, mix_override)
    finally:
        for k in PROGRAM_ENV:
            os.environ.pop(k, None)
        os.environ.update(saved)


def _run(argv, t_process, spec_path, mix_override):
    t_process = time.perf_counter() if t_process is None else t_process
    args = parse_args(argv)
    if args.seed < 0:
        raise RunError("--seed must be >= 0")
    cell, config, mix, e2e, per_layer = resolve_cell(args.workload, spec_path)
    for item in args.set:
        key, _, value = item.partition("=")
        mix_override = {**(mix_override or {}), key: json.loads(value)}
    if mix_override:
        mix = {**mix, **mix_override}
    if not (ROOT / PROGRAM).is_dir():
        raise RunError(f"the program ({PROGRAM}/) is not beside the benchmark in {ROOT}", 4)
    pin_caches()
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card only", 3)
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} cards, {torch.cuda.device_count()} visible", 3)
        print(f"card: {card_info()}", file=sys.stderr, flush=True)
    device = torch.device(args.device)
    if args.control == "int8":
        os.environ["MBEXWN_WN_QUANT"] = "int8"
    for path in (ROOT, BENCH, BENCH / "metrics"):
        sys.path.insert(0, str(path))
    import tracing

    ctx = SimpleNamespace(root=ROOT, config=config, mix=mix, seed=args.seed, device=device, control=args.control)
    runner = load_module(BENCH / "runners" / f"{mix['runner']}.py", mix["runner"]).Runner(ctx)
    tracer = tracing.Tracer(bool(args.trace), mix.get("trace_lead_s", 1.0), mix.get("trace_seconds", 2.0), device)
    runner.setup()
    if device.type == "cuda":
        from mbexwn_vocoder_torch.ops import kernel_lib
        print(f"kernel library: {kernel_lib.build_info.get('seconds')} s to build, "
              f"cached {kernel_lib.build_info.get('cached')}", file=sys.stderr)
    tracer.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
    # no cyclic collection in the window: a full collection of a process that
    # holds torch's objects, set off by the harness's own bookkeeping, stalls
    # the host for up to ~0.2 s; what set-up left is frozen out of later scans
    gc.collect()
    gc.freeze()
    gc.disable()
    runner.start(tracer)  # a lead-in before the window, where the traffic asks for one
    t_window = runner.window_start
    setup_s = t_window - t_process
    runner.run_window(args.seconds)
    gc.enable()
    tracer.stop()
    if device.type == "cuda":
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    runner.finish()
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that the port must not use: {found}", 5)

    result = {"correct": False, "attempted": runner.attempted, "failed": runner.failed}
    metrics = {}
    if args.trace:
        trace = tracer.reduce()
        if trace is None or trace.n_device == 0 and device.type == "cuda":
            raise RunError("the traced slice recorded no device activity", 6)
        run = SimpleNamespace(trace=trace, config=config, runner=runner)
        for m in per_layer:
            value = load_module(BENCH / "metrics" / f"{m['name']}.py", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": [[n, s] for n, s in trace.top_device_ops],
                     "idle_gaps": [[n, s] for n, s in trace.idle_gaps]}
    else:
        values = {"setup_s": setup_s, **runner.end_to_end(args.seconds)}
        for m in e2e:
            if m["name"] not in values:
                raise RunError(f"the {mix['runner']} runner does not measure {m['name']}", 7)
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    if args.trace:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)

    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    import check

    tally = check.Tally(config["preprocess_config"]["sample_rate"])
    t_check = time.perf_counter()
    try:
        runner.compare(tally)
    except Exception:  # an answer the check cannot compare is wrong; say why
        traceback.print_exc()
        tally.mark_wrong()
    tally.worst["missing"] = runner.missing
    limits = check.limits_for(cell["name"], ROOT)
    correct, checks = tally.verdict(limits)
    print(f"reference check: {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded that the port must not use: {found}", 5)
    result.update(correct=correct, metrics=metrics, device=device_info)
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    check.print_checks(checks, tally.n, sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result
