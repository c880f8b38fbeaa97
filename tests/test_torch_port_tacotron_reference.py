"""The port's Tacotron2 decode against the benchmark's plain float32
reference (`port_bench/reference/tacotron2.py`, which imports nothing of
the port), and the spans of `Tacotron2Wave.tts()`, on the CPU at the
benchmark's tiny rehearsal size in float32.

The weights are the benchmark's own recipe (`port_bench/systems/
tacotron2_hifigan.py`: one seeded draw, the pointer attention), loaded
through `Tacotron2Wave`'s public constructor, and once the draw alone,
without the pointer. The reference redraws the
prenet masks by the program's rule, so both decodes meet the same masks.
"""
import collections
import json
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.reference import tacotron2 as ref_t2
from tts_arabic_torch.eval.gate_control import (decode_in_tts_order,
                                                install_gate_control)
from tts_arabic_torch.runtime import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "port_bench" / "tests" / "data" /
                     "tiny-tacotron2-hifigan.json").read_text())
CAP = 160
TEXTS = ["bisomi {ll~ahi {lr~aHoma`ni", "qAla", "fiy {lbayoti kitAbN",
         "salAmN ElaykumN"]
STAGES = ("tts.frontend", "tts.encode", "tts.decode", "tts.vocode",
          "tts.denoise", "tts.collect")


def system():
    return harness.load_plugin("systems", "tacotron2_hifigan")


@pytest.fixture(scope="module")
def built():
    """The tiny pipeline in float32 on the CPU at a cap of CAP steps, its
    seeded weights, and the reference's state dict."""
    sys_ = system()
    cfg = json.loads(json.dumps(CONFIG))
    cfg["tacotron2"]["decoder_max_step"] = CAP
    weights = sys_.make_weights(cfg, 2 ** 31 + 5, torch.device("cpu"))
    with tempfile.TemporaryDirectory() as work:
        paths = sys_.write_checkpoints(cfg, weights, pathlib.Path(work))
        pipe = sys_.pipeline(cfg, paths, "cpu")
    return cfg, weights, pipe


def state_of(pipe) -> dict:
    return {k: v.detach().float().clone() for k, v in
            pipe.model.model.state_dict().items() if v.is_floating_point()}


def rows_of(pipe, texts, speakers):
    """The batched decode of `texts` as tts() decodes them, with each
    row's index in the decode's sorted batch (its prenet masks' row)."""
    m = pipe.model
    order = sorted(range(len(texts)), key=lambda i: -len(texts[i]))
    tokens, _ = m._prepare_tokens([texts[i] for i in order], None, False)
    padded = m._sorted_batch(tokens, np.asarray(speakers)[order],
                             len(texts))[0]
    out = decode_in_tts_order(m, texts, speakers)
    rows = []
    for text in texts:
        ids = ref_t2.ids(text)
        rows.append([r for r in range(len(texts))
                     if list(padded[r, :len(ids)]) == ids
                     and not padded[r, len(ids):].any()][0])
    return out, rows


def assert_rows_match(cfg, state, out, rows, texts, speakers):
    t2 = cfg["tacotron2"]
    masks = ref_t2.prenet_masks(t2, CAP, len(texts), "cpu")
    with torch.no_grad():
        for i, text in enumerate(texts):
            ids = ref_t2.ids(text)
            enc = ref_t2.encode(state, t2, ids, int(speakers[i]))
            mask = masks[:, :, rows[i]]
            free = ref_t2.decode(state, t2, enc, mask, max_steps=CAP)
            length = int(out["mel_lens"][i])
            assert len(free["mel"]) == length, text
            forced = ref_t2.decode(state, t2, enc, mask,
                                   frames=out["mel"][i, :length],
                                   align=out["alignments"][i, :length,
                                                           :len(ids)])
            for got in (free, forced):
                torch.testing.assert_close(got["mel"],
                                           out["mel"][i, :length],
                                           rtol=1e-4, atol=1e-5)
                torch.testing.assert_close(
                    got["align"], out["alignments"][i, :length, :len(ids)],
                    rtol=1e-4, atol=1e-4)
                torch.testing.assert_close(got["gate"],
                                           out["gates"][i, :length],
                                           rtol=1e-4, atol=1e-4)
                torch.testing.assert_close(
                    ref_t2.postnet(state, t2, got["mel"]),
                    out["mel_postnet"][i, :length], rtol=1e-4, atol=1e-4)
            if length < CAP:
                assert torch.sigmoid(forced["gate"][-1]) > 0.5
            assert (torch.sigmoid(forced["gate"][:-1]) <= 0.5).all()


def test_state_dict_layout(built):
    """The reference's leaves are the port's, name for name and shape for
    shape, and load strict."""
    cfg, weights, pipe = built
    want = pipe.model.model.state_dict()
    specs = {n: s for n, s, _ in ref_t2.param_specs(cfg["tacotron2"])}
    assert set(specs) == set(want)
    for n, shape in specs.items():
        assert tuple(want[n].shape) == tuple(shape), n


def test_drawn_attention_matches_reference(built):
    """The port's decode against the reference on the recipe's draw alone,
    without the pointer: every hidden unit of the attention reads the
    query, the memory's content and the location features, the gate is
    shut by its bias, and each row runs to the cap, free-running and
    teacher-forced in the reference with the same frames, gate logits and
    postnet mels."""
    cfg, weights, pipe = built
    drawn = system().make_weights(cfg, 2 ** 31 + 5, torch.device("cpu"),
                                  pointer=False)["tacotron2"]
    drawn["decoder.gate_layer.linear_layer.bias"].fill_(-100.0)
    net = pipe.model.model
    pristine = {k: v.detach().clone() for k, v in net.state_dict().items()}
    speakers = [1, 2, 4, 7]
    try:
        net.load_state_dict(drawn)
        out, rows = rows_of(pipe, TEXTS, speakers)
        assert out["mel_lens"].tolist() == [CAP] * len(TEXTS)
        assert_rows_match(cfg, state_of(pipe), out, rows, TEXTS, speakers)
    finally:
        net.load_state_dict(pristine)


def test_ragged_decode_matches_reference(built):
    """The port's decode of four rows whose gate fires at different steps
    (a gate bias that lets the pointer's ramp cross it at the speakers'
    own offsets), free-running and teacher-forced in the reference: the
    same stops, mels, gate logits and postnet mels."""
    cfg, weights, pipe = built
    net = pipe.model.model
    bias = net.decoder.gate_layer.linear_layer.bias
    pristine = bias.detach().clone()
    speakers = [0, 3, 5, 6]
    try:
        with torch.no_grad():
            bias.fill_(-100.0)
            shut, _ = rows_of(pipe, TEXTS, speakers)
            # the gate logit each row reaches a third into the cap, a
            # little above the others' so the rows stop apart
            g = shut["gates"][:, CAP // 3] - bias
            bias.copy_(-g.median().reshape(1))
        out, rows = rows_of(pipe, TEXTS, speakers)
        lengths = out["mel_lens"].tolist()
        assert len(set(lengths)) > 1 and min(lengths) < CAP, lengths
        assert_rows_match(cfg, state_of(pipe), out, rows, TEXTS, speakers)
    finally:
        with torch.no_grad():
            bias.copy_(pristine)


def test_gate_controlled_stops_match_reference(built):
    """Gate control (no cache) on the tiny model, aimed at 6 frames a
    token (inside the cap, where the pointer's ramp has a record at every
    step it moves): each row stops at its target, and the reference, on
    the rewired state, stops each row at the same step with the same
    frames."""
    cfg, weights, pipe = built
    sys_ = system()
    gate = dict(cfg["gate_control"], frames_per_token=6.0)
    targets = [sys_.target_frames(gate, len(ref_t2.ids(t)), CAP)
               for t in TEXTS]
    try:
        speakers, lengths, report = install_gate_control(
            pipe, TEXTS, targets, min_len=gate["min_len"], use_cache=False)
        assert report["off_target"] == 0 and report["n_fired"] == len(TEXTS)
        out, rows = rows_of(pipe, TEXTS, speakers)
        assert out["mel_lens"].tolist() == lengths.tolist()
        state = state_of(pipe)
        assert_rows_match(cfg, state, out, rows, TEXTS, speakers)
        # gate control wrote its own leaves and no other
        assert sys_.rewired_leaves(
            {k: v for k, v in pipe.model.model.state_dict().items()},
            weights["tacotron2"]) == 0
    finally:
        from tts_arabic_torch.eval import gate_control
        gate_control._Rewire.restore(pipe)


@pytest.fixture
def recording_cleared():
    profiling.clear()
    yield
    profiling.clear()


def test_tts_spans_and_counts(built, recording_cleared):
    """tts() of four texts at batch size 3 under recording(): one `tts`
    span, two of each per-batch stage under it with the call's id, the
    decode's `decode_steps` a multiple of the block, `fused_steps` 0 (the
    CPU's plain step), `rows` and `text_len` the padded batch's,
    `frames_vocoded` rows x bucket,
    `frames_kept` the waves' own frames; the waves bit-equal to the same
    call with recording off, which records nothing."""
    from tts_arabic_torch.models.tacotron2 import DECODE_BLOCK
    cfg, weights, pipe = built
    kw = dict(batch_size=3, denoise=0.005, postprocess_mel=False)
    want = pipe.tts(TEXTS, **kw)
    pipe.tts(TEXTS[0], **kw)
    assert profiling.recorded() == []
    with profiling.recording():
        got = pipe.tts(TEXTS, **kw)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    spans = profiling.recorded()
    (call,) = [s for s in spans if s.name == "tts"]
    by = collections.defaultdict(list)
    for s in spans:
        by[s.name].append(s)
        assert s.call == call.id
        if s is not call:
            assert s.parent == call.id, s
            assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    assert set(by) == {"tts", *STAGES}
    for name in STAGES:
        assert len(by[name]) == 2, name
    assert call.counts == {}
    assert [s.counts for s in by["tts.frontend"]] == [
        {"utterances": 3}, {"utterances": 1}]
    assert [s.counts for s in by["tts.encode"]] == [{}, {}]
    assert [s.counts for s in by["tts.denoise"]] == [{}, {}]
    for s in by["tts.decode"]:
        assert set(s.counts) == {"decode_steps", "fused_steps", "rows",
                                 "text_len"}
        # the CPU runs the plain step: no step on the fused kernels
        assert s.counts["fused_steps"] == 0
        assert s.counts["rows"] == 3 and s.counts["text_len"] % 16 == 0
        assert s.counts["decode_steps"] % DECODE_BLOCK == 0
        assert 0 < s.counts["decode_steps"] <= CAP + DECODE_BLOCK
    for s in by["tts.vocode"]:
        assert s.counts["frames_vocoded"] % 3 == 0
    hop = pipe.hop_length
    assert sum(s.counts["frames_kept"] for s in by["tts.collect"]) == sum(
        len(w) for w in got) // hop
    for s in spans:
        assert s.device_ms is None
