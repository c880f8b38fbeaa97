"""The Tacotron2 cell run by the harness on the CPU at a tiny size (the
harness's look for a card skipped): the result line's shape, `correct`
coming out false when the timed path is broken underneath (a token
altered, a stop moved, the denoiser skipped, the decode in float8), and a
reading where a call the check watches has gone. The controls at the
cell's own size need the card (marked `cuda`)."""
import json
import time
from unittest import mock

import pytest

import control
import control_tacotron2
import run
from port_bench import harness

TINY = json.loads((harness.HERE / "tests" / "data" /
                   "tiny-tacotron2-hifigan.json").read_text())
CELL = "tacotron2-gate-hifigan-v1.offline-gate-b16"


def tiny_cell():
    """The cell at the tiny size: its mix cut to one call of three
    prompts, its metrics and limits as they are."""
    cell = harness.resolve(CELL)
    mix = dict(cell.traffic, prompts_per_call=3, batch_size=3)
    return harness.Cell(cell.name, 1, TINY, mix, cell.end_to_end,
                        cell.per_layer, cell.limits)


def rehearse(trace=False, seed=2 ** 31 + 7):
    line, checks = run.run_cell(tiny_cell(), seed, 0.5, trace, "cpu",
                                time.perf_counter())
    return json.loads(json.dumps(line)), checks


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    line, checks = rehearse(trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    cell = tiny_cell()
    assert set(line["checks"]) == set(cell.limits)
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    if trace:
        # off the card no span has a device time and no ResBlock kernel
        # runs
        assert set(line["metrics"]) == want - {
            "decode_step_roofline.tacotron",
            "vocoder_device_us_per_audio_s.tacotron",
            "encode_device_us_per_audio_s.tacotron",
            "denoise_device_us_per_audio_s.tacotron",
            "resblock1_roofline.tacotron"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == want
    for name, c in line["checks"].items():
        assert f"check {name}: " in checks and c["value"] <= c["limit"]


def test_token_altered_is_not_correct():
    from tts_arabic_torch.infer.tacotron_pipeline import Tacotron2TTS
    sorted_batch = Tacotron2TTS._sorted_batch

    def altered(self, *a, **kw):
        padded, *rest = sorted_batch(self, *a, **kw)
        padded = padded.copy()
        padded[0, 2] = 1 + padded[0, 2] % 30
        return (padded, *rest)

    with mock.patch.object(Tacotron2TTS, "_sorted_batch", altered):
        line, _ = rehearse()
    assert line["correct"] is False
    assert line["checks"]["tokens_mismatched"]["value"] > 0


def test_stop_moved_is_not_correct():
    """Waves cut one frame short of the decode's stop."""
    from tts_arabic_torch.infer.tacotron_pipeline import Tacotron2Wave
    newlen = Tacotron2Wave._newlen_fn

    def early(*a, **kw):
        n_end, new_len = newlen(*a, **kw)
        return n_end, new_len - 1

    with mock.patch.object(Tacotron2Wave, "_newlen_fn",
                           staticmethod(early)):
        line, _ = rehearse()
    assert line["correct"] is False
    assert line["checks"]["stops_mismatched"]["value"] > 0


def test_denoiser_skipped_is_not_correct():
    with control.denoiser_as("denoiser-skipped"):
        line, _ = rehearse()
    assert line["correct"] is False
    assert line["checks"]["denoise_rel_err"]["value"] > 0.5


def test_decode_in_float8_is_not_correct():
    """The fp8 control's rounding, on the tiny float32 program: the
    decode leaves the reference's reach."""
    with control_tacotron2.decode_in_fp8():
        line, _ = rehearse()
    assert line["correct"] is False
    assert (line["checks"]["mel_rel_err"]["value"]
            > line["checks"]["mel_rel_err"]["limit"])


def test_reading_without_the_watched_calls():
    """With `_assemble_fn` under another name (the bucket not seen) the run
    still reports every number, the mels padded by the fallback; with
    `_infer` gone too, every utterance counts as unmatched."""
    from tts_arabic_torch.infer.tacotron_pipeline import (Tacotron2TTS,
                                                          Tacotron2Wave)

    def hidden(cls, name):
        real = cls.__dict__[name]

        def lookup(self, attr):
            if attr == name:
                return real.__get__(self, cls)
            raise AttributeError(attr)

        stack = [mock.patch.object(cls, name, None),
                 mock.patch.object(cls, "__getattr__", lookup, create=True)]
        return stack

    patches = hidden(Tacotron2Wave, "_assemble_fn")
    with patches[0], patches[1]:
        delattr(Tacotron2Wave, "_assemble_fn")
        line, _ = rehearse()
        for name, c in line["checks"].items():
            assert isinstance(c["value"], (int, float)), name
        assert line["checks"]["tokens_mismatched"]["value"] == 0
        more = hidden(Tacotron2TTS, "_infer")
        with more[0], more[1]:
            delattr(Tacotron2TTS, "_infer")
            line, _ = rehearse()
    assert line["failed"] == 0
    assert line["checks"]["tokens_mismatched"]["value"] == 3
    assert line["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_control_is_not_correct(kind):
    """The decode in float8 and the program's own int8 vocoder, at the
    cell's size and load on the card, fail the cell's limits."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = control_tacotron2.reading(harness.resolve(CELL), 2 ** 31 + 97,
                                    3.0, kind)
    assert got["correct"] is False
