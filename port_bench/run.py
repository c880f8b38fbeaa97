"""Runs one cell of the port's benchmark once, on the machine it is started
on, and prints the result as the last line of standard output:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, per-layer metrics and limits are
found by the names `BENCHMARK.json` gives them (`harness.py`). The run
makes its weights on the card from the seed, warms the shapes its traffic
uses, drives the cell's entry for `--seconds`, and then holds what the
timed path produced against the plain reference (`reference/`). With
`--trace 1` the window runs under torch.profiler and the line carries
the per-layer metrics; with `--trace 0`, the end-to-end ones. Without a
CUDA card, or with fewer than the cell asks for, it prints no result and
exits with 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def fix_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run in a checkout builds; no JAX behind a library's
    back."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def tracer(on: bool):
    """Around a driver's window: with `on`, torch.profiler (host and
    device) and the window's span; the box gets the window's Trace."""
    box = {}
    if not on:
        yield box
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import harness
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with record_function(harness.WINDOW_SPAN):
            yield box
        if on_card:
            torch.cuda.synchronize()
    box["trace"] = harness.read_profile(prof)


class Context:
    """What a per-layer reader reads: the window's trace, the requests it
    completed [(text, samples)], the generator calls' mel shapes, and the
    program (its configuration, dtype and FLOP counts)."""

    def __init__(self, trace, served, generator_calls, program):
        self.trace, self.served = trace, served
        self.generator_calls, self.program = generator_calls, program


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, **program_kw) -> tuple[dict, str]:
    """One run of `cell` on `device` -> (the result line's object, the
    lines that give each number compared beside its limit)."""
    import torch

    from port_bench import harness
    system = harness.load_plugin("systems", cell.config["system"])
    driver = harness.load_plugin("drivers", cell.traffic["driver"])
    on_card = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory(prefix="port_bench_") as work:
        program = system.Program(cell, seed, device, pathlib.Path(work),
                                 **program_kw)
        out = driver.run(program, cell, seed, seconds,
                         lambda: tracer(trace))
    setup_s = out["setup_end"] - t_start
    print(program.describe(out["served"]), flush=True)
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": (torch.cuda.get_device_name(device) if on_card
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else 0)}
    metrics, breakdown = {}, None
    if trace:
        tr = out["trace"]["trace"]
        ctx = Context(tr, out["served"], out["generator_calls"], program)
        for m in cell.per_layer:
            value = harness.load_plugin("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = harness.breakdown(tr)
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    program.free()
    t = time.perf_counter()
    numbers = program.check(out["samples"], out["denoised"])
    print(f"reference check of {len(out['samples'])} utterances: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    ok, checks = harness.check_lines(numbers, cell.limits)
    correct = ok and out["failed"] == 0
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    text = "\n".join(f"check {k}: {v['value']} (limit {v['limit']})"
                     for k, v in checks.items())
    return line, text


def power_line() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return got.stdout.strip() or got.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_environment()
    from port_bench import harness
    cell = harness.resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"port_bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {power_line()}", flush=True)
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"port_bench: the process loaded {found}", file=sys.stderr)
        return 3
    print(checks, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
