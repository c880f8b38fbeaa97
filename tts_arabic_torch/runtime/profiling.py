"""Profiling and timing (the port's counterpart of the JAX package's
`runtime/profiling.py`): labels on the profiler's timeline, a Chrome
trace of a block, a barrier on a tree of tensors, and a benchmark that
times the device's work: with CUDA events on the card (PyTorch returns
before the card finishes, so a host clock alone measures the enqueue),
with the host clock on the CPU.
"""
from __future__ import annotations

import contextlib
import pathlib
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch


def annotate(name: str):
    """Context manager: label the enclosed work on the profiler's
    timeline (`torch.profiler.record_function`; next to no cost when no
    profiler runs)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block (the host, and the card when there is
    one) and write a Chrome trace, `trace.json` under `log_dir` (open it
    in chrome://tracing or Perfetto). Yields the profiler, whose
    `key_averages()` sums the time by op."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree: Any) -> Any:
    """Wait until the card has finished the work behind every CUDA tensor
    in a tree of tensors (dicts, lists, tuples); returns the tree."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


@dataclass
class Timing:
    """Seconds a call: `times_s` of the timed runs (device time between
    CUDA events on the card, the host clock on the CPU), their median,
    min and spread (max - min), and the warm-up runs' host seconds."""
    times_s: Sequence[float]
    warmup_s: float
    device: str

    @property
    def median_s(self) -> float:
        return statistics.median(self.times_s)

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def spread_s(self) -> float:
        return max(self.times_s) - min(self.times_s)

    def __str__(self):
        return (f"median {self.median_s * 1e3:.3f} ms, best "
                f"{self.best_s * 1e3:.3f} ms, spread "
                f"{self.spread_s * 1e3:.3f} ms over {len(self.times_s)} "
                f"runs on {self.device} (warm-up {self.warmup_s:.2f} s)")


def benchmark(fn: Callable[[], Any], *, warmup: int = 1,
              iters: int = 5) -> Timing:
    """Time `fn` after `warmup` untimed runs. With a card, each run is
    timed by CUDA events recorded around it on the current stream, after
    a synchronize; without one, by the host clock."""
    cuda = torch.cuda.is_available()
    t0 = time.perf_counter()
    for _ in range(max(warmup, 0)):
        block(fn())
    if cuda:
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(max(iters, 1)):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return Timing(times_s=times, warmup_s=warmup_s,
                  device=torch.cuda.get_device_name() if cuda else "cpu")
