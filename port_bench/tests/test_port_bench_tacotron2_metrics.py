"""The Tacotron2 cell's per-layer readers on a synthetic trace and span
list: the decode's roofline share, the stopped rows' share, HiFi-GAN's
padding and device time, the idle share and MFU, the readers that take
the FastPitch cell's arithmetic, and nothing to read where the spans,
their counts or their device times are absent."""
import types

import pytest

import run
from port_bench import harness, yardstick, yardstick_tacotron2
from tts_arabic_torch.runtime import profiling

RATE, HOP = 22050, 256
CONFIG = harness.resolve("tacotron2-gate-hifigan-v1.offline-gate-b16").config
SPAN_METRICS = ["decode_step_roofline.tacotron", "stopped_row_share.tacotron",
                "vocode_pad_share.tacotron",
                "vocoder_device_us_per_audio_s.tacotron",
                "encode_device_us_per_audio_s.tacotron",
                "denoise_device_us_per_audio_s.tacotron",
                "frontend_us_per_utt.tacotron", "dispatch_idle_share.tacotron"]
# the readers that are the FastPitch cell's arithmetic under this cell's name
SHARED = ["vocode_pad_share", "vocoder_device_us_per_audio_s",
          "device_idle_share", "mfu", "resblock1_roofline",
          "encode_device_us_per_audio_s", "denoise_device_us_per_audio_s",
          "frontend_us_per_utt", "dispatch_idle_share"]


def reader(name):
    return harness.load_plugin("metrics", name).read


def span(name, start_s, end_s, device_ms=None, call=None, **counts):
    return types.SimpleNamespace(name=name, start_ns=round(start_s * 1e9),
                                 end_ns=round(end_s * 1e9), counts=counts,
                                 device_ms=device_ms, id=call, call=call)


class Program:
    config, dtype, sample_rate = CONFIG, "bfloat16", RATE

    def flops(self, text, n_samples):
        return 1_000_000 * len(text) + 7 * n_samples


def context(spans, monkeypatch, served, device_ops=(), start=100.0,
            end=110.0):
    def recorded(lo=None, hi=None):
        return [s for s in spans if s.end_ns >= lo and s.start_ns <= hi]

    monkeypatch.setattr(profiling, "recorded", recorded)
    trace = harness.Trace([(name, s, e) for name, s, e in device_ops], [],
                          start, end)
    return run.Context(trace, list(served), [(3, 192), (2, 128)], Program())


def two_calls():
    """Two calls in the window: one batch of 3 rows (text 16 long, 160
    steps), then one of 2 rows (text 32 long, 96 steps)."""
    out = []
    for call, a, rows, text_len, steps, kept, bucket in (
            (1, 101.0, 3, 16, 160, 300, 192), (2, 105.0, 2, 32, 96, 150,
                                               128)):
        out += [span("tts", a, a + 3.0, call=call),
                span("tts.frontend", a, a + 1e-4, call=call,
                     utterances=rows),
                span("tts.encode", a + 0.1, a + 0.2, 1.0, call=call),
                span("tts.decode", a + 0.2, a + 0.3, 40.0, call=call,
                     decode_steps=steps, rows=rows, text_len=text_len),
                span("tts.vocode", a + 0.3, a + 0.4, 12.0, call=call,
                     frames_vocoded=rows * bucket),
                span("tts.denoise", a + 0.4, a + 0.5, 0.5, call=call),
                span("tts.collect", a + 2.5, a + 3.0, call=call,
                     frames_kept=kept)]
    return out


SERVED = [("aaa", 100 * HOP), ("bb", 120 * HOP), ("c", 80 * HOP),
          ("dd", 90 * HOP), ("eeee", 60 * HOP)]


def test_decode_step_roofline(monkeypatch):
    ctx = context(two_calls(), monkeypatch, SERVED)
    t2 = CONFIG["tacotron2"]
    bound = (160 * yardstick_tacotron2.decode_step_bound_s(t2, 3, 16,
                                                           "bfloat16")
             + 96 * yardstick_tacotron2.decode_step_bound_s(t2, 2, 32,
                                                            "bfloat16"))
    assert reader("decode_step_roofline.tacotron")(ctx) == pytest.approx(
        100.0 * bound / 0.080)


def test_stopped_row_and_vocode_pad_shares(monkeypatch):
    ctx = context(two_calls(), monkeypatch, SERVED)
    assert reader("stopped_row_share.tacotron")(ctx) == pytest.approx(
        100.0 * (1.0 - 450 / (3 * 160 + 2 * 96)))
    assert reader("vocode_pad_share.tacotron")(ctx) == pytest.approx(
        100.0 * (1.0 - 450 / (3 * 192 + 2 * 128)))


def test_vocoder_device_us_per_audio_s(monkeypatch):
    ctx = context(two_calls(), monkeypatch, SERVED)
    audio_s = 450 * HOP / RATE
    assert reader("vocoder_device_us_per_audio_s.tacotron")(
        ctx) == pytest.approx(1e3 * 24.0 / audio_s)


def test_device_idle_share(monkeypatch):
    ctx = context([], monkeypatch, SERVED,
                  device_ops=[("op", 100.0, 104.0), ("op", 106.0, 109.0)])
    assert reader("device_idle_share.tacotron")(ctx) == pytest.approx(30.0)


def test_mfu_takes_each_utterances_own_frames(monkeypatch):
    """Every utterance at its own frames, whatever steps its batch ran:
    the same with the decode's steps doubled, and with no span at all."""
    p = Program()
    flops = sum(p.flops(t, n) for t, n in SERVED)
    want = 100.0 * flops / 10.0 / yardstick.PEAK_FLOPS["bfloat16"]
    spans = two_calls()
    assert reader("mfu.tacotron")(context(spans, monkeypatch,
                                          SERVED)) == pytest.approx(want)
    for s in spans:
        if s.name == "tts.decode":
            s.counts["decode_steps"] *= 2
    assert reader("mfu.tacotron")(context(spans, monkeypatch,
                                          SERVED)) == pytest.approx(want)
    assert reader("mfu.tacotron")(context([], monkeypatch,
                                          SERVED)) == pytest.approx(want)


@pytest.mark.parametrize("name", SHARED)
def test_shared_reader_is_the_fastpitch_cells(name, monkeypatch):
    """Each reader this cell shares with the FastPitch cell reads what the
    `.offline` one reads, on a window with spans, device operations (a
    ResBlock kernel among them) and generator calls."""
    ops = [("op", 100.5, 101.15), ("resblock1_pass_mma_kernel", 101.3,
                                     101.35), ("op", 105.15, 105.5)]
    ctx = context(two_calls(), monkeypatch, SERVED, device_ops=ops)
    got = reader(f"{name}.tacotron")(ctx)
    assert got is not None
    assert got == reader(f"{name}.offline")(ctx)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read_without_spans(name, monkeypatch):
    assert reader(name)(context([], monkeypatch, SERVED)) is None
    ctx = context(two_calls(), monkeypatch, SERVED)
    monkeypatch.delattr(profiling, "recorded")
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", ["decode_step_roofline.tacotron",
                                  "vocoder_device_us_per_audio_s.tacotron",
                                  "encode_device_us_per_audio_s.tacotron",
                                  "denoise_device_us_per_audio_s.tacotron"])
def test_no_device_time_off_the_card(name, monkeypatch):
    spans = two_calls()
    for s in spans:
        s.device_ms = None
    assert reader(name)(context(spans, monkeypatch, SERVED)) is None


def test_nothing_to_read_without_the_decode_counts(monkeypatch):
    """A program whose decode span counts nothing (before it counted
    steps) gives no roofline or stopped-row share."""
    spans = two_calls()
    for s in spans:
        if s.name == "tts.decode":
            s.counts = {}
    ctx = context(spans, monkeypatch, SERVED)
    for name in ("decode_step_roofline.tacotron",
                 "stopped_row_share.tacotron"):
        assert reader(name)(ctx) is None, name
