"""The readers of the program's spans, on a synthetic trace and span list:
the dispatch idle, the host stages' idle and the caller's idle add up to
the device's idle share (and to `tools.stage_split`'s split of the idle
by innermost span), the mel padding share, the stages' device us per audio second,
the frontend's us per utterance, and nothing to read where the spans or
their device times are absent (off the card, or a program that records
none)."""
import types

import pytest

import run
from port_bench import harness
from tts_arabic_torch.runtime import profiling
from tts_arabic_torch.tools import stage_split

RATE = 22050
STAGES = {"encode_device_us_per_audio_s.offline": "tts.encode",
          "decode_device_us_per_audio_s.offline": "tts.decode",
          "vocoder_device_us_per_audio_s.offline": "tts.vocode",
          "denoise_device_us_per_audio_s.offline": "tts.denoise"}
SPAN_METRICS = [*STAGES, "frontend_us_per_utt.offline",
                "mel_pad_share.offline", "dispatch_idle_share.offline"]


def reader(name):
    return harness.load_plugin("metrics", name).read


def span(name, start_s, end_s, device_ms=None, **counts):
    return types.SimpleNamespace(name=name, start_ns=round(start_s * 1e9),
                                 end_ns=round(end_s * 1e9), counts=counts,
                                 device_ms=device_ms)


def context(spans, monkeypatch, device_ops=(), served=((None, 3 * RATE),),
            start=100.0, end=110.0):
    """A Context over the window [start, end] s, whose program recorded
    `spans` (`profiling.recorded` returns those in the window)."""
    def recorded(lo=None, hi=None):
        return [s for s in spans if s.end_ns >= lo and s.start_ns <= hi]

    monkeypatch.setattr(profiling, "recorded", recorded)
    trace = harness.Trace([("op", s, e) for s, e in device_ops], [], start,
                          end)
    program = types.SimpleNamespace(sample_rate=RATE)
    return run.Context(trace, list(served), [], program)


def two_calls():
    """Two calls of the program in the window [100, 110] s, with stages
    under each, and a span of another call before the window."""
    out = [span("tts", 90.0, 92.0), span("tts.encode", 90.5, 91.0, 50.0)]
    for a, b in ((101.0, 104.0), (105.0, 109.0)):
        out += [span("tts", a, b),
                span("tts.frontend", a, a + 1e-4, utterances=2),
                span("tts.encode", a + 0.1, a + 0.2, 1.5),
                span("tts.decode", a + 0.2, a + 0.3, 2.0,
                     frames_decoded=512),
                span("tts.vocode", a + 0.3, a + 0.4, 10.0),
                span("tts.denoise", a + 0.4, a + 0.5, 0.75),
                span("tts.collect", b - 0.5, b, frames_kept=384)]
    return out


def test_dispatch_host_and_callers_idle_add_up_to_the_idle_share(
        monkeypatch):
    # device busy 6.5 of the 10 s; idle gaps [100, 100.5] (no call open),
    # [101.5, 102] (in the first call's encode-to-collect stretch),
    # [103, 103.5] (its middle before the collect), [106, 107] (in the
    # second call's), [108.6, 108.9] (in its collect) and [109.3, 110]
    # (its middle after the second call ended)
    ops = [(100.5, 101.5), (102.0, 103.0), (103.5, 106.0), (107.0, 108.6),
           (108.9, 109.3)]
    spans = two_calls()
    ctx = context(spans, monkeypatch, ops)
    dispatch = reader("dispatch_idle_share.offline")(ctx)
    idle = reader("device_idle_share.offline")(ctx)
    assert dispatch == pytest.approx(20.0)
    assert idle == pytest.approx(35.0)
    host, callers = 100.0 * 0.3 / 10.0, 100.0 * (0.5 + 0.7) / 10.0
    assert dispatch + host + callers == pytest.approx(idle)
    # the same split by innermost span, as the stage_split tool gives it
    by = stage_split.idle_by_span(ctx.trace.gaps(),
                                  [s for s in spans if s.end_ns >= 100e9])
    assert set(by) == {"tts", "tts.collect", stage_split.NO_SPAN}
    assert 10.0 * by["tts"] == pytest.approx(dispatch)
    assert 10.0 * by["tts.collect"] == pytest.approx(host)
    assert 10.0 * by[stage_split.NO_SPAN] == pytest.approx(callers)


def test_innermost_span():
    where = stage_split.innermost(two_calls())
    assert where(90.7) == "tts.encode"
    assert where(91.5) == "tts"
    assert where(95.0) == stage_split.NO_SPAN
    assert where(101.15) == "tts.encode"
    assert where(101.25) == "tts.decode"
    assert where(108.7) == "tts.collect"
    assert where(108.2) == "tts"


def test_dispatch_idle_counts_every_gap(monkeypatch):
    """A thousand short gaps inside one call count whole, beyond the 400
    that the breakdown names."""
    ops = [(101.0 + 2e-3 * i, 101.0 + 2e-3 * i + 1e-3) for i in range(1000)]
    spans = [span("tts", 100.9, 103.1)]
    ctx = context(spans, monkeypatch, ops)
    got = reader("dispatch_idle_share.offline")(ctx)
    # the 999 gaps between ops; the gaps before the first op and after
    # the last have their middles outside the call
    assert got == pytest.approx(100.0 * 999 * 1e-3 / 10.0, rel=1e-6)


def test_mel_pad_share(monkeypatch):
    ctx = context(two_calls(), monkeypatch)
    assert reader("mel_pad_share.offline")(ctx) == pytest.approx(
        100.0 * (1.0 - 2 * 384 / (2 * 512)))


@pytest.mark.parametrize("name", STAGES)
def test_stage_device_us_per_audio_s(name, monkeypatch):
    ms = {"tts.encode": 1.5, "tts.decode": 2.0, "tts.vocode": 10.0,
          "tts.denoise": 0.75}[STAGES[name]]
    served = [("a", 2 * RATE), ("b", RATE), ("c", RATE)]    # 4 audio s
    ctx = context(two_calls(), monkeypatch, served=served)
    assert reader(name)(ctx) == pytest.approx(1e3 * 2 * ms / 4.0)


def test_frontend_us_per_utt(monkeypatch):
    ctx = context(two_calls(), monkeypatch)
    assert reader("frontend_us_per_utt.offline")(ctx) == pytest.approx(
        2 * 100.0 / 4, rel=1e-3)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read_without_spans(name, monkeypatch):
    ops = [(100.5, 101.5)]
    assert reader(name)(context([], monkeypatch, ops)) is None
    # a program whose profiling module records no spans
    ctx = context(two_calls(), monkeypatch, ops)
    monkeypatch.delattr(profiling, "recorded")
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", STAGES)
def test_no_device_time_off_the_card(name, monkeypatch):
    spans = [span(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9, None,
                  **s.counts) for s in two_calls()]
    assert reader(name)(context(spans, monkeypatch)) is None
