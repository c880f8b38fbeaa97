"""The one traffic generator: turns a mix's parameters
(`traffic/<mix>.json`) and a seed into the requests a driver sends. The
same seed gives the same requests; the program receives only the texts.

Parameters read here:
- `prompts`: a text file under this directory, one prompt a line;
- `prompts_per_call`, `distinct_calls`, `calls_seed` (closed-loop batch
  calls): `distinct_calls` calls, each a sample of that many distinct
  prompts drawn once from `calls_seed`, so that every seed does the same
  work; the run's seed orders the calls in the window's cycle and the
  prompts in each call. All are met once in set-up.
"""
from __future__ import annotations

import random

from port_bench.harness import HERE


def prompts(mix: dict) -> list[str]:
    lines = (HERE / mix["prompts"]).read_text(encoding="utf-8").splitlines()
    return [t.strip() for t in lines if t.strip()]


def batch_calls(mix: dict, seed: int) -> list[list[str]]:
    """`distinct_calls` calls of `prompts_per_call` distinct prompts: the
    mix's fixed set, in the seed's order."""
    lines = prompts(mix)
    draw = random.Random(f"calls:{mix['calls_seed']}")
    calls = [draw.sample(lines, mix["prompts_per_call"])
             for _ in range(mix["distinct_calls"])]
    order = random.Random(f"order:{seed}")
    order.shuffle(calls)
    for call in calls:
        order.shuffle(call)
    return calls

