"""The port's spans and counts (`runtime.profiling.span`, `count`,
`recording`, `recorded`) on the CPU: when they record, what each span
holds, the shared clock with torch.profiler, and the spans of one
`FastPitch2Wave.tts()` on a narrow seeded model."""
import collections
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_weights import write_weights
from tts_arabic_torch.runtime import profiling

STAGES = ("tts.frontend", "tts.encode", "tts.decode", "tts.vocode",
          "tts.denoise", "tts.collect")
TEXTS = ["bisomi {ll~ahi", "{lr~aHoma`ni {lr~aHiymi", "qAla",
         "fiy {lbayoti kitAbN", "salAmN"]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear()
    yield
    profiling.clear()


def test_off_records_nothing_and_on_records():
    assert not profiling.enabled()
    with profiling.span("a", n=1):
        profiling.count(n=2)
    assert profiling.recorded() == []
    with profiling.recording():
        assert profiling.enabled()
        with profiling.span("b"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.enabled()
        with profiling.span("c"):
            pass
    assert not profiling.enabled()
    with profiling.span("d"):
        pass
    assert [s.name for s in profiling.recorded()] == ["b", "c"]


def test_parents_calls_counts_and_device_time_off_the_card():
    with profiling.recording():
        with profiling.span("call", utterances=3) as outer:
            with profiling.span("stage", device=torch.device("cpu"),
                                rows=2) as inner:
                profiling.count(rows=1, tokens=7)
                with profiling.span("leaf") as leaf:
                    pass
            profiling.count(done=1)
        with profiling.span("next") as other:
            pass
    assert (outer.parent, outer.call) == (None, outer.id)
    assert (inner.parent, inner.call) == (outer.id, outer.id)
    assert (leaf.parent, leaf.call) == (inner.id, outer.id)
    assert (other.parent, other.call) == (None, other.id)
    assert outer.counts == {"utterances": 3, "done": 1}
    assert inner.counts == {"rows": 3, "tokens": 7}
    assert inner.device_ms is None      # no events off the card
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns
    assert leaf.end_ns <= inner.end_ns <= outer.end_ns
    # finished order; a window keeps the spans that lie in it
    assert [s.name for s in profiling.recorded()] == ["leaf", "stage",
                                                      "call", "next"]
    assert [s.name for s in profiling.recorded(
        other.start_ns, other.end_ns)] == ["next"]
    assert [s.name for s in profiling.recorded(
        leaf.start_ns, leaf.end_ns)] == ["leaf", "stage", "call"]
    assert profiling.recorded(other.end_ns + 1) == []


def test_buffer_drops_the_oldest_past_its_cap():
    with mock.patch.object(profiling, "_buffer",
                           collections.deque(maxlen=3)):
        with profiling.recording():
            for i in range(5):
                with profiling.span(f"s{i}"):
                    pass
        assert [s.name for s in profiling.recorded()] == ["s2", "s3", "s4"]
        assert profiling.dropped() == 2
        profiling.clear()
        assert profiling.recorded() == [] and profiling.dropped() == 0


def test_each_thread_keeps_its_own_stack():
    started, release = threading.Event(), threading.Event()

    def worker():
        with profiling.span("worker"):
            started.set()
            release.wait(10)
            with profiling.span("worker.child"):
                pass

    with profiling.recording():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            started.wait(10)
            with profiling.span("main.child"):
                release.set()
            t.join(10)
    by = {s.name: s for s in profiling.recorded()}
    assert by["worker"].parent is None
    assert by["worker.child"].parent == by["worker"].id
    assert by["worker.child"].call == by["worker"].id
    assert by["main.child"].parent == by["main"].id


def test_spans_share_the_profilers_clock_and_stay_off_its_timeline():
    """An aten op recorded inside a span lies within the span's start and
    end on the profiler's own clock, and no span name is a profiler
    event."""
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clock.outer"):
            time.sleep(0.005)
            with profiling.span("clock.inner"):
                x @ x
            time.sleep(0.005)
    (outer,) = [s for s in profiling.recorded() if s.name == "clock.outer"]
    events = prof.profiler.kineto_results.events()
    mm = [e for e in events if e.name() == "aten::mm"]
    assert len(mm) == 1
    start = mm[0].start_ns()
    assert outer.start_ns <= start
    assert start + mm[0].duration_ns() <= outer.end_ns
    assert not {e.name() for e in events} & {"clock.outer", "clock.inner"}


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    from tts_arabic_torch.infer import FastPitch2Wave
    fp, voc, voc_cfg = write_weights(tmp_path_factory.mktemp("tracing"))
    return FastPitch2Wave(model_sd_path=fp, vocoder_sd=voc,
                          vocoder_config=voc_cfg, arabic_in=False,
                          device="cpu")


def test_tts_spans_and_counts(pipe):
    """tts() of 5 texts at batch size 2 under recording(): one `tts` span,
    three of each per-batch stage under it, `frames_kept` the waves' own
    frames, `frames_decoded` rows x bucket; the waves bit-equal to a call
    made with recording off."""
    from tts_arabic_torch.infer.pipeline import FastPitchTTS
    kw = dict(batch_size=2, denoise=0.005)
    want = pipe.tts(TEXTS, **kw)
    assert profiling.recorded() == []
    decode, buckets = FastPitchTTS._decode_fn, []

    def watched(self, *a, **k):
        buckets.append(k["max_frames"])
        return decode(self, *a, **k)

    with profiling.recording(), \
            mock.patch.object(FastPitchTTS, "_decode_fn", watched):
        got = pipe.tts(TEXTS, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    spans = profiling.recorded()
    (call,) = [s for s in spans if s.name == "tts"]
    assert call.counts == {}
    by = collections.defaultdict(list)
    for s in spans:
        by[s.name].append(s)
        assert s.call == call.id
        if s is not call:
            assert s.parent == call.id, s
            assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    assert set(by) == {"tts", *STAGES}
    for name in STAGES:
        assert len(by[name]) == 3, name
    assert [s.counts for s in by["tts.frontend"]] == [
        {"utterances": n} for n in (2, 2, 1)]
    assert [s.counts for s in by["tts.encode"]] == [{}] * 3
    assert len(buckets) == 3
    assert [s.counts for s in by["tts.decode"]] == [
        {"frames_decoded": 2 * b} for b in buckets]
    hop = pipe.hop_length
    assert sum(s.counts["frames_kept"] for s in by["tts.collect"]) == sum(
        len(w) for w in got) // hop
    for s in spans:
        assert s.device_ms is None


def test_tts_records_nothing_when_off(pipe):
    pipe.tts(TEXTS[:2], batch_size=2)
    pipe.tts(TEXTS[0])
    assert profiling.recorded() == []


def test_threads_lose_no_span():
    """Sixteen threads record into a buffer of 500 at a short switch
    interval: every span is kept or counted as dropped, and no id
    repeats."""
    import sys
    n_threads, per_thread = 16, 200

    def worker():
        for _ in range(per_thread):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    profiling.count(n=1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with mock.patch.object(profiling, "_buffer",
                               collections.deque(maxlen=500)), \
                profiling.recording():
            threads = [threading.Thread(target=worker)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            kept = profiling.recorded()
            assert len(kept) == 500
            assert len(kept) + profiling.dropped() == \
                2 * n_threads * per_thread
            assert len({s.id for s in kept}) == len(kept)
            for s in kept:
                if s.name == "inner":
                    assert s.counts == {"n": 1} and s.parent is not None
    finally:
        sys.setswitchinterval(interval)
