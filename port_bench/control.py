"""Readings of the numbers a cell compares, for setting their limits: the
program as the configuration states it (the sound runs), its controls, and
planted faults, each on several seeds in one process, at the cell's own
size and load, each judged by the harness's own comparison (`check`,
`check_lines`), so each prints `correct` beside its numbers.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13 \
        --seconds 4 --kinds sound int8 tf32 bf16-denoiser denoiser-skipped

Kinds:
- `sound`: the program as stated, a short window at the cell's load;
- `int8`: the control of the bf16 decode and vocoder: the program with its
  own int8 path switched on (the decoder's FFN and HiFi-GAN's MRF stages);
- `tf32`: the control of the float32 encode: the reference with TF32 on,
  in the program's place, over the utterances of the seed's first call
  (its durations, frames, waves and denoiser calls);
- `bf16-denoiser`: the control of the float32 denoiser (its FFTs have no
  TF32 path): the program with its denoiser's input and output rounded to
  bfloat16;
- `denoiser-skipped`, `denoiser-doubled`: planted faults, the program's
  denoiser returning its input, or taking off twice the strength asked.

One JSON line per reading. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from unittest import mock

import run


def tf32_in_place(cell, seed: int, device) -> dict:
    """The reference with TF32 on, in the program's place, judged by the
    cell's own comparison against the reference in full float32."""
    import numpy as np
    import torch

    from port_bench import harness, traffic
    from port_bench.reference import tokens as ref_tokens
    system = harness.load_plugin("systems", cell.config["system"])
    weights = system.make_weights(cell.config, seed, device)
    tf32 = system.Reference(cell.config, weights, device, tf32=True)
    denoise = cell.traffic["denoise"]
    samples, denoised = [], []
    for text in traffic.batch_calls(cell.traffic, seed)[0]:
        ids = ref_tokens.ids(text)
        dur = tf32.durations(ids)
        reps = np.floor(dur + 0.5).astype(np.int64)
        pad_to = int(reps.sum()) + system.FALLBACK_PAD_FRAMES
        before = tf32.vocoded(ids, reps, pad_to)
        after = tf32.denoise(before, denoise)
        denoised.append((before[None], after[None]))
        wave = after[: int(reps.sum()) * tf32.hop].cpu().numpy()
        records = system.Records({system.key(ids): (torch.as_tensor(dur),
                                                    pad_to)}, [])
        samples.append((text, wave, records))
    del tf32
    ref = system.Reference(cell.config, weights, device)
    numbers = system.check(samples, denoised, ref, denoise)
    ok, _ = harness.check_lines(numbers, cell.limits)
    return {"correct": ok, "numbers": numbers, "utterances": len(samples)}


@contextlib.contextmanager
def denoiser_as(kind: str):
    """The program's denoiser replaced for one kind of reading."""
    from tts_arabic_torch.vocoder import denoiser
    real = denoiser.denoise
    if kind == "bf16-denoiser":
        def fn(audio, bias, strength):
            out = real(audio.bfloat16().float(), bias, strength)
            return out.bfloat16().float()
    elif kind == "denoiser-skipped":
        def fn(audio, bias, strength):
            return audio
    elif kind == "denoiser-doubled":
        def fn(audio, bias, strength):
            return real(audio, bias, 2 * strength)
    else:
        yield
        return
    with mock.patch.object(denoiser, "denoise", fn):
        yield


KINDS = ("sound", "int8", "tf32", "bf16-denoiser", "denoiser-skipped",
         "denoiser-doubled")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--kinds", nargs="+", choices=KINDS, required=True)
    args = p.parse_args(argv)
    run.fix_environment()
    from port_bench import harness
    cell = harness.resolve(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for kind in args.kinds:
            if kind == "tf32":
                got = tf32_in_place(cell, seed, "cuda")
            else:
                kw = {"quantize": "int8"} if kind == "int8" else {}
                with denoiser_as(kind):
                    line, _ = run.run_cell(cell, seed, args.seconds, False,
                                           "cuda", time.perf_counter(), **kw)
                got = {"correct": line["correct"],
                       "numbers": {k: v["value"] for k, v in
                                   line["checks"].items()},
                       "metrics": {k: v["value"] for k, v in
                                   line["metrics"].items()}}
            print(json.dumps({"kind": kind, "seed": seed, **got}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
