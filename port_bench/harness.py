"""The general part of the benchmark: finds a cell's pieces by their names
in `BENCHMARK.json`, makes seeded weights on the device, reads the
profiler's trace, and prints the result line.

Every piece that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

- `configs/<file>` (the path `BENCHMARK.json` gives): the sizes, the
  dtype, the weight recipe and the `system` that builds the program;
- `systems/<system>.py`: builds the program from a configuration, and
  holds the program's outputs against the plain reference (`reference/`);
- `traffic/<traffic>.json`: the mix's parameters, read by
  `traffic.py`, and the `driver` that runs its loop;
- `drivers/<driver>.py`: the loop that drives the entry for the window;
- `metrics/<metric>.py`: one reader per per-layer metric;
- `limits/<workload>.json`: each number the cell compares, with its limit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in the process that prints a result,
# compared with each module's top-level name whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tts_arabic_tpu")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_plugin(kind: str, name: str):
    """The module `<kind>/<name>.py` beside this file (a name may hold
    dots, so it is loaded by path)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"port_bench_{kind}_{name.replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    end_to_end: list      # the end-to-end metric entries it reports
    per_layer: list       # the per-layer metric entries it reports
    limits: dict          # number name -> limit


def resolve(workload: str, spec: dict | None = None) -> Cell:
    spec = spec or load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(workload, w["chips"], config, traffic, e2e, per_layer,
                limits["limits"])


# ---- seeded weights ----------------------------------------------------------

def seeded_state_dict(specs: list, seed: int, device) -> dict:
    """A state dict made on `device` from `seed`: every normal leaf is cut
    from one draw of a `torch.Generator` on the device and scaled by its
    own std in one multiply; then copied to the host in one transfer.
    `specs` is [(name, shape, init)], init ("normal", std), ("zeros",),
    ("ones",) or ("inv_freq", dim) (the sinusoid's frequencies)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    normal = [i for i, (_, _, init) in enumerate(specs)
              if init[0] == "normal"]
    n = sum(sizes[i] for i in normal)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    stds = torch.tensor([specs[i][2][1] for i in normal], device=device)
    flat *= torch.repeat_interleave(
        stds, torch.tensor([sizes[i] for i in normal], device=device))
    flat = flat.cpu()
    out, pos = {}, 0
    for i, (name, shape, init) in enumerate(specs):
        if init[0] == "normal":
            out[name] = flat[pos: pos + sizes[i]].view(shape)
            pos += sizes[i]
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape)
        elif init[0] == "ones":
            out[name] = torch.ones(shape)
        elif init[0] == "inv_freq":
            d = init[1]
            out[name] = (1.0 / 10000.0 ** (torch.arange(
                0.0, d, 2.0, dtype=torch.float64) / d)).float()
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out


# ---- the profiler's trace ----------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What the per-layer readers read from a traced window: the device's
    operations [(name, start s, end s)], the host's operations and the
    benchmark's own spans [(name, start s, end s)], on one clock, and the
    window's bounds on it."""
    device_ops: list
    host_ops: list
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        busy, hi = 0.0, None
        lo = None
        for s, e in sorted((s, e) for _, s, e in self.device_ops):
            if hi is None or s > hi:
                if hi is not None:
                    busy += hi - lo
                lo, hi = s, e
            else:
                hi = max(hi, e)
        return busy + (hi - lo if hi is not None else 0.0)

    def gaps(self) -> list:
        """The device's idle intervals inside the window [(start, end)]."""
        out, t = [], self.start
        for s, e in sorted((s, e) for _, s, e in self.device_ops):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out

    def op_seconds(self, pattern: str) -> float:
        return sum(e - s for n, s, e in self.device_ops if pattern in n)


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0][:80]


WINDOW_SPAN = "port_bench.window"


def read_profile(prof) -> Trace:
    """A Trace from a finished torch.profiler session, cut to the window:
    the host span WINDOW_SPAN that the driver opened around it."""
    import torch
    try:
        events = prof.profiler.kineto_results.events()
        rows = [(e.name(), e.device_type(), e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in events]
    except AttributeError:        # an older profiler: its event tree
        rows = [(e.name, e.device_type, int(e.time_range.start * 1e3),
                 int(e.time_range.end * 1e3)) for e in prof.events()]
    cpu = torch.autograd.DeviceType.CPU
    spans = [(s, e) for n, k, s, e in rows if n == WINDOW_SPAN and k == cpu]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    start_ns, end_ns = spans[0]
    dev, host = [], []
    for name, kind, s, e in rows:
        if e <= start_ns or s >= end_ns or name == WINDOW_SPAN:
            continue
        s, e = max(s, start_ns), min(e, end_ns)
        (host if kind == cpu else dev).append((name, s * 1e-9, e * 1e-9))
    return Trace(dev, host, start_ns * 1e-9, end_ns * 1e-9)


def breakdown(trace: Trace) -> dict:
    """The device operations with the most time, and the device's idle
    time by what the host was doing: the innermost host operation or span
    open at the middle of each gap, for the 400 longest gaps; the rest
    summed as one entry."""
    import numpy as np
    by_op: dict = {}
    for n, s, e in trace.device_ops:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0.0) + e - s
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])
    by_host: dict = {}
    if trace.host_ops:
        hs = np.array([s for _, s, _ in trace.host_ops])
        he = np.array([e for _, _, e in trace.host_ops])
        names = [n for n, _, _ in trace.host_ops]
    for a, b in gaps[:400]:
        key = "no host op"
        if trace.host_ops:
            mid = 0.5 * (a + b)
            open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
            if len(open_):
                key = short_name(names[open_[np.argmax(hs[open_])]])
        by_host[key] = by_host.get(key, 0.0) + b - a
    rest = sum(b - a for a, b in gaps[400:])
    if rest:
        by_host["shorter gaps"] = rest
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


# ---- the result ----------------------------------------------------------------

def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def check_lines(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    out = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
