"""A closed loop with one caller: each call of the entry starts when the
last has returned, cycling through the mix's calls (`traffic.
batch_calls`), every one of which set-up has run once. The window runs
whole cycles: it ends with the cycle in which `seconds` have passed, so
that every run does the same work in each cycle whatever the seed's
order; the rate is all the audio the window completed over all its
time.

For the check it keeps, drawn from the seed, `checked_calls` of the
window's calls (a reservoir sample), with their denoiser calls, and the
longest utterance served."""
from __future__ import annotations

import random
import time

from port_bench import traffic


def run(program, cell, seed: int, seconds: float, tracer) -> dict:
    mix = cell.traffic
    calls = traffic.batch_calls(mix, seed)
    cap = program.capture
    with cap.installed():
        program.warm(calls)
        cap.take()
        rng = random.Random(f"check:{seed}")
        kept, longest, served = [], None, []
        attempted = failed = 0
        setup_end = time.perf_counter()
        with tracer() as box, program.generator_calls() as gen_calls:
            t0 = time.perf_counter()
            while (attempted % len(calls)
                   or time.perf_counter() - t0 < seconds):
                texts = calls[attempted % len(calls)]
                attempted += 1
                try:
                    waves = program.call(texts)
                except Exception:           # counted; the run goes on
                    failed += 1
                    cap.take()
                    continue
                records = cap.take()
                served.extend((t, len(w)) for t, w in zip(texts, waves))
                got = [(t, w, records) for t, w in zip(texts, waves)]
                done = attempted - failed
                if len(kept) < mix["checked_calls"]:
                    kept.append(got)
                elif rng.randrange(done) < mix["checked_calls"]:
                    kept[rng.randrange(mix["checked_calls"])] = got
                top = max(got, key=lambda g: len(g[1]))
                if longest is None or len(top[1]) > len(longest[1]):
                    longest = top
            window_s = time.perf_counter() - t0
    samples = [g for call in kept for g in call]
    denoised = [d for call in kept for d in call[0][2].denoised]
    if longest is not None and all(longest[0] != s[0] for s in samples):
        samples.append(longest)
    audio_s = sum(n for _, n in served) / program.sample_rate
    return {"setup_end": setup_end, "window_s": window_s,
            "attempted": attempted, "failed": failed,
            "e2e": {"audio_s_per_s": audio_s / window_s},
            "samples": samples, "denoised": denoised, "served": served,
            "generator_calls": gen_calls, "trace": box}
