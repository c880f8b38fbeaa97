"""A run of the harness on the CPU at a tiny size (the harness's look for
a card skipped): the result line's shape, `correct` coming out false when
the timed path is broken underneath (a token or an answer altered where it
is produced, the denoiser skipped or at the wrong strength), and a reading
where a call the check watches has gone. The controls at the cell's own
size need the card (marked `cuda`)."""
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest

import run
from port_bench import harness

TINY = json.loads((harness.HERE / "tests" / "data" /
                   "tiny-fastpitch-hifigan.json").read_text())
OFFLINE = "fastpitch-hifigan-v1.offline-b16"


def tiny_cell(workload=OFFLINE):
    """The workload's cell at the tiny size: its mix cut to a few short
    calls, its metrics and limits as they are."""
    cell = harness.resolve(workload)
    mix = dict(cell.traffic, prompts_per_call=3, distinct_calls=2,
               batch_size=2)
    return harness.Cell(cell.name, 1, TINY, mix, cell.end_to_end,
                        cell.per_layer, cell.limits)


def rehearse(cell, trace=False, seed=2 ** 31 + 7):
    line, checks = run.run_cell(cell, seed, 1.0, trace, "cpu",
                                time.perf_counter())
    return json.loads(json.dumps(line)), checks


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    line, checks = rehearse(tiny_cell(), trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"] for m in (tiny_cell().per_layer if trace
                                else tiny_cell().end_to_end)}
    assert set(line["metrics"]) <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
    for name, c in line["checks"].items():
        assert f"check {name}: " in checks and c["value"] <= c["limit"]


def test_token_altered_is_not_correct():
    from tts_arabic_torch.infer.pipeline import FastPitchTTS
    ids = FastPitchTTS._ids

    def altered(self, utterance):
        out = ids(self, utterance).copy()
        out[len(out) // 2] = 1 + out[len(out) // 2] % 30
        return out

    with mock.patch.object(FastPitchTTS, "_ids", altered):
        line, _ = rehearse(tiny_cell())
    assert line["correct"] is False
    assert line["checks"]["tokens_mismatched"]["value"] > 0


def test_answer_altered_is_not_correct():
    from tts_arabic_torch.infer.pipeline import FastPitch2Wave
    collect = FastPitch2Wave._collect_batch

    def altered(self, handles, return_mel):
        waves = collect(self, handles, return_mel)
        waves[0] = waves[0] * np.float32(1.25)
        return waves

    with mock.patch.object(FastPitch2Wave, "_collect_batch", altered):
        line, _ = rehearse(tiny_cell())
    assert line["correct"] is False
    assert line["checks"]["wave_rel_err"]["value"] > 0.2


@pytest.mark.parametrize("fault", ["denoiser-skipped",
                                   "denoiser-doubled"])
def test_denoiser_fault_is_not_correct(fault):
    import control
    with control.denoiser_as(fault):
        line, _ = rehearse(tiny_cell())
    assert line["correct"] is False
    assert line["checks"]["denoise_rel_err"]["value"] > 0.5


def test_reading_without_the_decode_call():
    """With `_decode_fn` under another name (the buckets not seen), the run
    still reports every number, the mels padded by the fallback."""
    from tts_arabic_torch.infer.pipeline import FastPitchTTS
    decode = FastPitchTTS._decode_fn

    def lookup(self, name):
        if name == "_decode_fn":
            return decode.__get__(self)
        raise AttributeError(name)

    with mock.patch.object(FastPitchTTS, "_decode_fn", None), \
            mock.patch.object(FastPitchTTS, "__getattr__", lookup,
                              create=True):
        del FastPitchTTS._decode_fn
        line, _ = rehearse(tiny_cell())
    assert line["failed"] == 0
    for name, c in line["checks"].items():
        assert isinstance(c["value"], (int, float)), name
    assert line["checks"]["tokens_mismatched"]["value"] == 0


def test_no_card_no_result():
    got = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", OFFLINE,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode != 0 and got.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [OFFLINE])
def test_control_is_not_correct(workload):
    """The program's own int8 path, at the cell's size and load on the
    card, fails the cell's limits."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line, _ = run.run_cell(harness.resolve(workload), 2 ** 31 + 99, 3.0,
                           False, "cuda", time.perf_counter(),
                           quantize="int8")
    assert line["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [OFFLINE])
def test_tf32_control_is_not_correct(workload):
    """The reference with TF32 on, in the program's place at the cell's
    size on the card, fails the cell's limits through its comparison."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import control
    got = control.tf32_in_place(harness.resolve(workload), 2 ** 31 + 98,
                                "cuda")
    assert got["correct"] is False
