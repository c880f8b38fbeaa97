"""Where the time to the first streamed chunk goes on the card, against the
whole `tts_single` of the same utterance.

    python -m tts_arabic_torch.tools.stream_split

Builds `chip_smoke.py`'s serving configuration on the card (full-width
FastPitch and HiFi-GAN V1, seeded, the duration bias raised by 2.0, bf16),
joins the first prompts of data/infer_text.txt until `stream()` makes 8
chunks of 128 frames, and prints, each as the min and the median of 5
runs on the host clock ending in a synchronize unless said otherwise:

- what `capture_graphs()` costs: its wall seconds and the device memory
  its graphs hold;
- the stages of a first chunk run one at a time: tokenize (its words
  met before, and none of them met), encode and decode (replayed from
  their CUDA graphs, and eager), a window's generator (with a
  synchronize, its host dispatch alone, and its device critical path by
  CUDA events with the host ahead), the generator at the whole call's
  mel bucket (device critical path), both device paths again with each
  stage's ResBlocks in turn on one stream, the denoiser;
- the first chunk and the whole `tts_single`, each with the graphs and
  eager;

then, under `torch.profiler`, the device kernels, device ms and host ms of
each of those four and of the eager encode, and the encode's five device
kernels with the most time.
"""
from __future__ import annotations

import argparse
import pathlib
import re
import time
from unittest import mock

import numpy as np
import torch

from ..infer import FastPitch2Wave
from ..infer import pipeline as pl
from ..text import phonetizer
from ..vocoder import denoiser
from ..vocoder.hifigan import Generator

ROOT = pathlib.Path(__file__).resolve().parents[2]
CHUNK, OVERLAP, MIN_CHUNKS = 128, 16, 8
REPS = 5
SLEEP_CYCLES = 200_000_000  # ~100 ms of device time at the H100's clocks


def prompts() -> list[str]:
    label = re.compile(r'"[^"]+"\s+"(?P<text>[^"]+)"')
    out = []
    for line in (ROOT / "data" / "infer_text.txt").read_text().splitlines():
        m = label.match(line)
        text = m.group("text") if m else line
        if text.strip():
            out.append(text)
    return out


def timed(fn, mode: str = "sync") -> tuple[float, float]:
    """(min, median) ms of fn() over REPS runs after one warm run. "sync":
    host clock to the synchronize; "host": host clock to fn's return (host
    dispatch); "device": CUDA events around fn() queued behind a ~100 ms
    device sleep, so the host has queued all of fn's work before the
    device reaches it (the device's critical path, the host's pace
    excluded)."""
    fn()
    runs = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        if mode == "device":
            torch.cuda._sleep(SLEEP_CYCLES)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
            continue
        t0 = time.perf_counter()
        fn()
        if mode == "sync":
            torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return min(runs), float(np.median(runs))


def profile(fn, top: int = 0):
    """(device kernels, device ms, host ms) of fn() under torch.profiler,
    and its `top` device kernels with the most device time as (name,
    calls, ms)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    cuda = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    cuda.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.count for e in cuda),
            sum(e.self_device_time_total for e in cuda) / 1e3,
            sum(e.self_cpu_time_total for e in ka) / 1e3,
            [(e.key, e.count, e.self_device_time_total / 1e3)
             for e in cuda[:top]])


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    pipe = FastPitch2Wave(seed=0, arabic_in=False,
                          compute_dtype=torch.bfloat16)
    with torch.no_grad():
        pipe.model.model.duration_predictor.fc.bias.add_(2.0)
    m = pipe.model
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    m.capture_graphs(torch.bfloat16)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_mib = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    texts = prompts()
    for n in range(4, len(texts) + 1):
        text = " ".join(texts[:n])
        if m.ttmel(text).shape[1] > (MIN_CHUNKS - 1) * CHUNK:
            break
    kw = dict(chunk_frames=CHUNK, overlap=OVERLAP, denoise=0.005)
    window = CHUNK + 2 * OVERLAP
    bucket0 = pl._pick_mel_bucket(max(window, pl.STREAM_SPEC_FRAMES))
    ids = m.tokenize(text)
    enc = m._encode_batch([ids], 0, 1.0, 0.0, None, 1.0)[0]
    enc_out = enc["enc_out"].to(torch.bfloat16)

    def eager(fn):
        def run():
            with mock.patch.dict(m._graphs, clear=True):
                return fn()
        return run

    def encode():
        return m._encode_batch([ids], 0, 1.0, 0.0, None, 1.0)

    def decode():
        with pl._exact_f32():
            return m._decode_fn(enc_out, enc["dur_pred"], 1.0,
                                max_frames=bucket0)[0]

    mel = decode()
    piece = mel[:, :window].contiguous()
    with pl._exact_f32():
        wave = pipe.vocoder(piece).float()

    def gen():
        with pl._exact_f32():
            pipe.vocoder(piece)

    bucket = pl._pick_mel_bucket(int(enc["dec_len_max"]))
    whole_piece = mel[:, :bucket].contiguous()

    def gen_whole():
        with pl._exact_f32():
            pipe.vocoder(whole_piece)

    def in_turn(fn):
        """fn with each stage's ResBlocks run one after another on one
        stream, as before they had streams of their own."""
        def fuse(blocks, x):
            acc = blocks[0](x)
            for block in blocks[1:]:
                acc = acc + block(x)
            return acc / len(blocks)

        def run():
            with mock.patch.object(Generator, "_fuse", staticmethod(fuse)):
                return fn()
        return run

    def first():
        g = pipe.stream(text, **kw)
        next(g)
        g.close()

    def full():
        pipe.tts_single(text, denoise=0.005)

    def uncached_tokenize():
        phonetizer.clear_word_cache()
        return m.tokenize(text)

    print(f"{torch.cuda.get_device_name(0)} | the first {n} prompts joined: "
          f"{len(text)} characters, {len(ids)} tokens, "
          f"{int(enc['dec_len_max'])} frames, chunks of {CHUNK} | "
          f"capture_graphs() {capture_s:.3f} s, {len(m._graphs)} graphs "
          f"holding {graph_mib:.1f} MiB")
    ends = [("first chunk, graphs", first), ("first chunk, eager",
                                             eager(first)),
            ("whole tts_single, graphs", full),
            ("whole tts_single, eager", eager(full))]
    rows = [
        ("tokenize", lambda: m.tokenize(text), "sync"),
        ("tokenize, no word met before", uncached_tokenize, "sync"),
        ("encode, graph", encode, "sync"),
        ("encode, eager", eager(encode), "sync"),
        (f"decode at {bucket0}, graph", decode, "sync"),
        (f"decode at {bucket0}, eager", eager(decode), "sync"),
        (f"generator, {window} frames", gen, "sync"),
        (f"generator, {window} frames, host dispatch", gen, "host"),
        (f"generator, {window} frames, device path", gen, "device"),
        (f"generator, {window} frames, device path, in turn", in_turn(gen),
         "device"),
        (f"generator, {bucket} frames, device path", gen_whole, "device"),
        (f"generator, {bucket} frames, device path, in turn",
         in_turn(gen_whole), "device"),
        ("denoise, one window", lambda: denoiser.denoise(
            wave, pipe.bias_spec, 0.005), "sync"),
    ] + [(name, fn, "sync") for name, fn in ends]
    for name, fn, mode in rows:
        lo, med = timed(fn, mode)
        print(f"    {name:42} min {lo:8.3f} ms  median {med:8.3f} ms")
    for name, fn in ends + [("encode, eager", eager(encode))]:
        n_k, dev_ms, host_ms, _ = profile(fn)
        print(f"    profiled {name:33} {n_k:5d} device kernels, device "
              f"{dev_ms:7.3f} ms, host {host_ms:7.3f} ms")
    print("    the eager encode's device kernels with the most time:")
    for key, calls, ms in profile(eager(encode), top=5)[3]:
        print(f"        {ms:7.3f} ms in {calls:3d} calls  {key[:70]}")


if __name__ == "__main__":
    main()
