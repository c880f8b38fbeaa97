"""Where a benchmark window's time goes, stage by stage: the window's device
idle time by the program span open at each gap, and each device
operation's time by the span open when the host launched it.

    python -m tts_arabic_torch.tools.stage_split --out split.json -- \\
        --workload fastpitch-hifigan-v1.offline-b16 --seed 1 \\
        --seconds 20 --trace 1

Runs the benchmark (`port_bench/run.py` of the current directory, from
the root of a checkout) in this process with the arguments after `--`,
and prints its result line as it does. A `--trace 1` run also writes to
`--out` a JSON object of:

- `idle_by_span`: the idle seconds of every device gap of the window
  (`Trace.gaps()`, all of them), by the innermost program span
  (`runtime.profiling.span`) open at the gap's middle, or `no span`;
- `stage_device_s`, `stage_host_s`: each span name's CUDA-event device
  seconds (the stage's first queued work to its last, its waits for its
  own dispatch included) and its host seconds;
- `device_op_s_by_stage`, `elementwise_s_by_stage`, `device_ops_by_stage`:
  the device operations that began in the window, put down to the
  innermost span open when the host launched each (the profiler's
  correlation ids): their seconds, those of PyTorch's elementwise
  kernels, and the 12 operations with the most time for each span;
- `stage_counts`: each span name's counts (`span(..., **counts)`,
  `profiling.count`) summed over the window's spans, e.g. the Tacotron2
  decode's `decode_steps` beside its `fused_steps`;
- `window_s`, `busy_s`, `idle_s`, `n_gaps`, `dtoh_s` (the copies back),
  `n_spans`, `dropped`.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import runpy
import sys

NO_SPAN = "no span"


def innermost(spans):
    """A function of a time t (s) that gives the name of the innermost
    span of `spans` open at t, or NO_SPAN. Spans nest or follow each other,
    as those of one thread do."""
    levels: list = []
    stack: list = []
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1] <= s.start_ns:
            stack.pop()
        if len(levels) == len(stack):
            levels.append(([], []))
        starts, rows = levels[len(stack)]
        starts.append(s.start_ns * 1e-9)
        rows.append((s.end_ns * 1e-9, s.name))
        stack.append(s.end_ns)

    def where(t: float) -> str:
        for starts, rows in reversed(levels):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rows[i][0]:
                return rows[i][1]
        return NO_SPAN
    return where


def idle_by_span(gaps, spans) -> dict:
    """The gaps' seconds [(start s, end s)] by the innermost span open at
    each gap's middle."""
    where, out = innermost(spans), {}
    for a, b in gaps:
        k = where(0.5 * (a + b))
        out[k] = out.get(k, 0.0) + b - a
    return out


def device_by_stage(prof, spans, start: float, end: float) -> dict:
    """The device operations of a finished torch.profiler session that
    began in [start, end] s, by the innermost span open at their launch
    (the host operation with the same correlation id). The device copies
    of the benchmark's window range are left out, as `read_profile`
    leaves them."""
    import torch

    from port_bench import harness
    where = innermost(spans)
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    launch: dict = {}
    for e in events:
        if e.device_type() == cpu and e.correlation_id():
            launch.setdefault(e.correlation_id(), e.start_ns() * 1e-9)
    by: dict = {}
    for e in events:
        if (e.device_type() == cpu or e.name() == harness.WINDOW_SPAN
                or not start <= e.start_ns() * 1e-9 <= end):
            continue
        t = launch.get(e.correlation_id(),
                       launch.get(e.linked_correlation_id()))
        k = where(t) if t is not None else "unmatched"
        d = by.setdefault(k, {})
        n = harness.short_name(e.name())
        d[n] = d.get(n, 0.0) + e.duration_ns() * 1e-9
    return {
        "device_op_s_by_stage": {k: sum(v.values()) for k, v in by.items()},
        "elementwise_s_by_stage": {
            k: sum(x for n, x in v.items() if "elementwise" in n)
            for k, v in by.items()},
        "device_ops_by_stage": {
            k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:12])
            for k, v in by.items()}}


def split(trace, prof) -> dict:
    """The JSON object the module's docstring lists, for a window read by
    `harness.read_profile` from `prof`."""
    from ..runtime import profiling
    spans = profiling.recorded(round(trace.start * 1e9),
                               round(trace.end * 1e9))
    gaps = trace.gaps()
    out = {"window_s": trace.window_s, "busy_s": trace.busy_s(),
           "idle_s": sum(b - a for a, b in gaps), "n_gaps": len(gaps),
           "dtoh_s": trace.op_seconds("DtoH"),
           "idle_by_span": idle_by_span(gaps, spans),
           "stage_device_s": {}, "stage_host_s": {}, "stage_counts": {},
           "n_spans": len(spans), "dropped": profiling.dropped()}
    for s in spans:
        counts = out["stage_counts"].setdefault(s.name, {})
        for key, n in s.counts.items():
            counts[key] = counts.get(key, 0) + n
        if s.device_ms is not None:
            out["stage_device_s"][s.name] = (
                out["stage_device_s"].get(s.name, 0.0) + s.device_ms * 1e-3)
        out["stage_host_s"][s.name] = (out["stage_host_s"].get(s.name, 0.0)
                                       + (s.end_ns - s.start_ns) * 1e-9)
    out.update(device_by_stage(prof, spans, trace.start, trace.end))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the JSON file to write")
    ap.add_argument("bench", nargs=argparse.REMAINDER,
                    help="-- then port_bench/run.py's arguments")
    args = ap.parse_args(argv)
    bench = args.bench[1:] if args.bench[:1] == ["--"] else args.bench
    root = os.getcwd()
    sys.path.insert(0, root)
    from port_bench import harness
    box: dict = {}
    read_profile, breakdown = harness.read_profile, harness.breakdown

    def read_profile_kept(prof):
        box["prof"] = prof
        return read_profile(prof)

    def breakdown_and_split(trace):
        with open(args.out, "w") as f:
            json.dump(split(trace, box["prof"]), f, indent=1)
        return breakdown(trace)

    harness.read_profile = read_profile_kept
    harness.breakdown = breakdown_and_split
    run = os.path.join(root, "port_bench", "run.py")
    sys.argv = [run, *bench]
    runpy.run_path(run, run_name="__main__")


if __name__ == "__main__":
    main()
