"""Readings of the numbers the Tacotron2 cell compares, for setting their
limits: the program as the configuration states it (the sound runs) and
its controls, each on several seeds in one process, at the cell's own size
and load, each judged by the harness's own comparison, so each prints
`correct` beside its numbers (as `control.py` does for its kinds).

    python3 port_bench/control_tacotron2.py \
        --workload tacotron2-gate-hifigan-v1.offline-gate-b16 \
        --seeds 11 12 13 --seconds 4 --kinds sound fp8 int8 bf16-denoiser

Kinds:
- `sound`: the program as stated, a short window at the cell's load;
- `fp8`: the control of the bf16 decode: the program with every input of
  each decoder step (the prenet's output, the states it carries, the
  memory and the decoder's weights) rounded to float8 e4m3, the graphs
  captured with it (`decode_in_fp8`);
- `int8`: the control of the bf16 vocoder: the program's own int8 path;
- `bf16-denoiser`: the control of the float32 denoiser, as in
  `control.py`.

One JSON line per reading. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from unittest import mock

import control
import run

FP8_MAX = 448.0          # the largest finite float8 e4m3 (fn) value


def fp8(x):
    """x rounded to float8 e4m3 (saturated at its largest finite value),
    back in x's dtype."""
    import torch
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


def _rounded(tree):
    """Every floating tensor of a tree of dicts, lists and tuples rounded
    to float8 e4m3."""
    if isinstance(tree, dict):
        return {k: _rounded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rounded(v) for v in tree)
    if getattr(tree, "is_floating_point", lambda: False)():
        return fp8(tree)
    return tree


@contextlib.contextmanager
def decode_in_fp8():
    """The program's decoder step with every input rounded to float8 e4m3:
    the prenet's output, the states it carries (the attention and LSTM
    states, the previous frame), the memory and its attention keys, and
    the decoder's weights."""
    from tts_arabic_torch.models.tacotron2 import Tacotron2
    step = Tacotron2._decode_step

    def rounded(self, state, prenet_out, enc, w, keep=None):
        return step(self, _rounded(state), fp8(prenet_out), _rounded(enc),
                    _rounded(w), keep)

    with mock.patch.object(Tacotron2, "_decode_step", rounded):
        yield


KINDS = ("sound", "fp8", "int8", "bf16-denoiser")


def reading(cell, seed: int, seconds: float, kind: str) -> dict:
    kw = {"quantize": "int8"} if kind == "int8" else {}
    fault = decode_in_fp8() if kind == "fp8" else control.denoiser_as(kind)
    with fault:
        line, _ = run.run_cell(cell, seed, seconds, False, "cuda",
                               time.perf_counter(), **kw)
    return {"correct": line["correct"],
            "numbers": {k: v["value"] for k, v in line["checks"].items()},
            "metrics": {k: v["value"] for k, v in line["metrics"].items()}}


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
        print("control_tacotron2: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {run.power_line()}", flush=True)
    for seed in args.seeds:
        for kind in args.kinds:
            got = reading(cell, seed, args.seconds, kind)
            print(json.dumps({"kind": kind, "seed": seed, **got}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
