"""Profiling and timing (the port's counterpart of the JAX package's
`runtime/profiling.py`): spans and counts inside the program, a Chrome
trace of a block, a barrier on a tree of tensors, and a benchmark that
times the device's work: with CUDA events on the card (PyTorch returns
before the card finishes, so a host clock alone measures the enqueue),
with the host clock on the CPU.

Spans. `with span("tts.decode", device=dev, frames_decoded=n):` records, while
recording is on, the stage's name, an id, the id of its parent (the
innermost span open on the same thread), a call id (the outermost open
span's, shared by every span of one request), its counts, and its start
and end from `time.time_ns()`. `count(frames_kept=n)` adds counts to the
innermost open span. With `device` a CUDA device a span also records two
timing CUDA events on that device's current stream: their
`elapsed_time` is the stage's device time, from when the device reaches
the stage's first queued work to when it finishes its last, gaps in
which the stage waited for its own dispatch included.

Recording is on while a `torch.profiler` records, and inside
`recording()`, the operator's switch (off by default); `enabled()` says
whether it is. When it is off a span costs one flag check: no record, no
clock read, no event. A count's value is computed by its caller, so a
count that costs work goes behind `if enabled():`. A span never
synchronises, reads a device value or calls `record_function` or NVTX,
so it puts nothing on the profiler's device timeline.

Finished spans are kept in memory, at most CAPACITY of them (the oldest
dropped past it; `dropped()` counts them). `recorded(start_ns, end_ns)`
returns those that lie in a window, device times resolved (the
caller synchronises first); `clear()` empties the buffer.

The shared clock: the profiler stamps its host events in Unix-epoch
nanoseconds, the clock of `time.time_ns()`, so a span's `start_ns` and
`end_ns` lie on a `trace()`'s timeline, to the profiler's own clock
conversion (well under a millisecond).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import pathlib
import statistics
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

CAPACITY = 1_000_000          # spans kept; the oldest dropped past it

_profiler_enabled = torch._C._autograd._profiler_enabled
_switched_on = 0              # depth of open recording() blocks
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """Record spans inside the block (with or without a profiler)."""
    global _switched_on
    with _lock:
        _switched_on += 1
    try:
        yield
    finally:
        with _lock:
            _switched_on -= 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded span (see the module's docstring); `device_ms` is
    its device time in ms, None where it recorded no events."""
    __slots__ = ("id", "parent", "call", "name", "start_ns", "end_ns",
                 "counts", "_events", "_device_ms")

    def __init__(self, name: str, device, counts: dict):
        self.id = next(_ids)
        self.name, self.counts = name, counts
        self.parent = self.call = None
        self.start_ns = self.end_ns = 0
        self._events = None
        self._device_ms = None
        if device is not False and torch.device(device).type == "cuda":
            self._events = (torch.device(device),
                            torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent, self.call = stack[-1].id, stack[0].id
        else:
            self.call = self.id
        stack.append(self)
        if self._events is not None:
            dev, start, _ = self._events
            start.record(torch.cuda.current_stream(dev))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end_ns = time.time_ns()
        if self._events is not None:
            dev, _, end = self._events
            end.record(torch.cuda.current_stream(dev))
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                _dropped += 1
            _buffer.append(self)
        return False

    @property
    def device_ms(self):
        if self._device_ms is None and self._events is not None:
            _, start, end = self._events
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, {self.end_ns - self.start_ns} ns, "
                f"{self.counts})")


def enabled() -> bool:
    """Whether spans are recorded now (a profiler runs, or inside
    `recording()`)."""
    return bool(_switched_on or _profiler_enabled())


def span(name: str, *, device=False, **counts):
    """Context manager: a span named `name` with these counts (a no-op
    while recording is off). `device`: False, or the device the stage's
    work is queued on; on a CUDA device the span also records its device
    time."""
    if not (_switched_on or _profiler_enabled()):
        return _OFF
    return Span(name, device, counts)


def count(**counts) -> None:
    """Add counts to the innermost open span of this thread (a no-op
    while recording is off or no span is open)."""
    if not (_switched_on or _profiler_enabled()):
        return
    stack = _stack()
    if stack:
        own = stack[-1].counts
        for k, v in counts.items():
            own[k] = own.get(k, 0) + v


def recorded(start_ns: int | None = None,
             end_ns: int | None = None) -> list:
    """The finished spans that lie in [start_ns, end_ns], wholly or in
    part (every one kept, by default), in the order they finished, their
    device times resolved: call after the device has finished their
    work. (In part: the profiler's clock conversion may set a window's
    edge a fraction of a millisecond off a span's.)"""
    with _lock:
        spans = list(_buffer)
    out = [s for s in spans
           if (start_ns is None or s.end_ns >= start_ns)
           and (end_ns is None or s.start_ns <= end_ns)]
    for s in out:
        s.device_ms             # resolves the events' time, then drops them
    return out


def dropped() -> int:
    """Spans dropped from the full buffer since the last clear()."""
    return _dropped


def clear() -> None:
    """Forget every recorded span."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


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
