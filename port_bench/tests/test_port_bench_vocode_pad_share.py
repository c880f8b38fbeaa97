"""The reader of HiFi-GAN's padding share, `vocode_pad_share.offline`, on a
synthetic span list (the helpers of `test_port_bench_tracing_metrics`):
the share of the vocoded frames no utterance keeps, and nothing to read
where the program records no spans, or spans without the
`frames_vocoded` count (a program that vocodes every batch at its
bucket and does not count)."""
import types

import pytest

from test_port_bench_tracing_metrics import context, reader, two_calls
from tts_arabic_torch.runtime import profiling

NAME = "vocode_pad_share.offline"


def counted(spans, frames_vocoded):
    """The spans, each `tts.vocode` one counting `frames_vocoded`."""
    return [types.SimpleNamespace(**{
        **vars(s), "counts": {**s.counts, "frames_vocoded": frames_vocoded}})
        if s.name == "tts.vocode" else s for s in spans]


def test_vocode_pad_share(monkeypatch):
    ctx = context(counted(two_calls(), 448), monkeypatch)
    assert reader(NAME)(ctx) == pytest.approx(
        100.0 * (1.0 - 2 * 384 / (2 * 448)))


@pytest.mark.parametrize("case", ["no spans", "no recorder", "no count"])
def test_nothing_to_read(case, monkeypatch):
    ops = [(100.5, 101.5)]
    spans = [] if case == "no spans" else (
        two_calls() if case == "no count" else counted(two_calls(), 448))
    ctx = context(spans, monkeypatch, ops)
    if case == "no recorder":
        monkeypatch.delattr(profiling, "recorded")
    assert reader(NAME)(ctx) is None
