"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100): builds the CUDA kernels from `tts_arabic_torch/csrc`, holds every
kernel variant against its plain PyTorch version on the card, drives
`FastPitch2Wave.tts()` at full width, and checks what comes out.

    python3 chip_smoke.py

Phases, one line each (and a table for the kernel checks):
1. device: nvidia-smi's name and power limit, torch's device name
2. kernel build (nvcc, sm_90a) and its seconds
   (then one untimed warm tts() of phase 4, which records the mel shapes
   of its generator calls)
3. kernel checks: resblock1 wide (C 256/128/64) and narrow (C 64/32),
   k 3/7/11, dilations 1/3/5, f32 and bf16, at the main path's widths and
   stage lengths (each generator call's frames x the stage's samples per
   frame, batch 8), and once 3 rows shorter, which no tile divides, against
   `resblock1_plain`: f32 with TF32 off; bf16 against the plain version run
   in f32 on the same bf16 inputs. At the main path's lengths: the
   kernel's ms, the plain version's ms (same dtype) and the bound
4. main path: full-width FastPitch (d_model 384, 6+6 layers) + HiFi-GAN V1
   in bf16 on 16 prompts of data/infer_text.txt, batch 8, denoise 0.005,
   random weights from seed 0 with the duration head biased by +2.0; the
   launch counters are set to 0 just before the timed tts() and read just
   after
5. whole-generator check: f32 tts_single on 2 prompts through the kernels,
   then with the generator's ResBlocks on `resblock1_plain`; SNR > 40 dB

Then nvidia-smi's line again, the kernels' JSON record (its ms, plain_ms
and bound_ms summed over the main path's bf16 launches of each kernel, as
timed in phase 3), and last the result line. Any failure raises and the exit code is not 0; without a CUDA
device the script exits 1 before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DILATIONS = (1, 3, 5)
KERNEL_SIZES = (3, 7, 11)
N_PROMPTS = 16
BATCH = 8
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain: max |kernel - plain| <= TOL * max |plain|. f32: the two
# differ by summation order only; bf16: the kernel rounds each conv output
# and residual to bf16 (as the TPU kernel rounds to x.dtype), the plain
# reference runs in f32
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
WIDE_CHANNELS = (256, 128, 64)
NARROW_CHANNELS = (64, 32)
STAGE_T = {256: 8, 128: 64, 64: 128, 32: 256}   # samples per mel frame


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over `reps` runs after one warm run."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[1 device] {smi} | torch: {name} | count "
        f"{torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi, name


def phase_build() -> None:
    from tts_arabic_torch.ops import build
    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if re.search(r"registers|spill", ln)]
    log(f"[2 build] resblock1.cu -> sm_90a in {took:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    for ln in ptxas:
        log(f"    ptxas: {ln}")


def _case(C: int, k: int, T: int, dtype, gen: torch.Generator):
    """Inputs on the card: x ~ N(0, 1), weights ~ N(0, 1/(k C)) (the
    lecun-normal scale of the random init), biases ~ N(0, 0.1)."""
    n = len(DILATIONS)
    rand = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda")
    x = rand(BATCH, T, C)
    w1, w2 = (rand(n, C, C, k) / (k * C) ** 0.5 for _ in range(2))
    b1, b2 = (0.1 * rand(n, C) for _ in range(2))
    return x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2


def bound(C: int, k: int, T: int, dtype) -> tuple[float, float]:
    """Least times (ms) for one ResBlock1 on [BATCH, T, C]: 6 convs of
    2 k C^2 FLOPs per row at the dtype's peak, and x read once, y written
    once and the weights read once at the memory rate."""
    esize = torch.finfo(dtype).bits // 8
    flops = 12 * k * C * C * BATCH * T
    nbytes = 2 * BATCH * T * C * esize + 6 * k * C * C * esize + 6 * C * 4
    return flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3


def _rel_err(rb, name, C, k, T, dtype, gen):
    """Runs the kernel once on fresh inputs and holds it against the plain
    version in f32 on the same inputs; returns (inputs, abs err, rel
    err)."""
    x, w1, b1, w2, b2 = _case(C, k, T, dtype, gen)
    got = _launch(rb, name, x, w1, b1, w2, b2, k).float()
    ref = rb.resblock1_plain(x.float(), w1.float(), b1, w2.float(), b2, k,
                             DILATIONS)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not rel <= TOL[dtype]:
        raise AssertionError(f"{name} C={C} k={k} T={T} {dtype}: error "
                             f"{rel:.3e} of max|plain| > {TOL[dtype]}")
    return (x, w1, b1, w2, b2), err, rel


def _launch(rb, name, x, w1, b1, w2, b2, k):
    """The kernel through its wrapper; C=64 is also run through the narrow
    (fused) variant, which the main path serves with the wide one."""
    if rb.variant(x.shape[-1]) == name:
        return rb.resblock1(x, w1, b1, w2, b2, k, DILATIONS)
    with mock.patch.object(rb, "variant", lambda C: name):
        return rb.resblock1(x, w1, b1, w2, b2, k, DILATIONS)


def phase_kernel_checks(frames: list[int]) -> dict:
    """Every variant, width, kernel size and dtype at the stage lengths of
    the main path's generator calls (`frames` mel frames each; a length
    that recurs is timed once and counted for each call), and once at a
    length 3 rows short of the first, which no tile divides."""
    from tts_arabic_torch.ops import resblock as rb
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    set_tf32(False)     # f32 plain convs in full f32, not TF32
    log(f"[3 kernel checks] B={BATCH}, T = stage length of the main path's "
        f"generator calls ({' and '.join(map(str, frames))} frames), and "
        "of the first less 3 rows; err = max|kernel - plain| / max|plain|")
    log(f"    {'variant':17} {'C':>4} {'k':>3} {'dtype':>5} {'T':>7} "
        f"{'err':>9} {'tol':>7} {'ms':>9} {'plain_ms':>9} {'bound_ms':>9}")
    variants = ([("resblock1_wide", C) for C in WIDE_CHANNELS]
                + [("resblock1_narrow", C) for C in NARROW_CHANNELS])
    for name, C in variants:
        for k in KERNEL_SIZES:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")[:5]
                T = STAGE_T[C] * frames[0] - 3
                _, _, rel = _rel_err(rb, name, C, k, T, dtype, gen)
                log(f"    {name:17} {C:>4} {k:>3} {dname:>5} {T:>7} "
                    f"{rel:>9.2e} {TOL[dtype]:>7.0e}")
                for f, n_calls in collections.Counter(frames).items():
                    T = STAGE_T[C] * f
                    args, err, rel = _rel_err(rb, name, C, k, T, dtype, gen)
                    ms = cuda_ms(lambda: _launch(rb, name, *args, k))
                    plain_ms = cuda_ms(lambda: rb.resblock1_plain(
                        *args, k, DILATIONS))
                    t_ops, t_bytes = bound(C, k, T, dtype)
                    log(f"    {name:17} {C:>4} {k:>3} {dname:>5} {T:>7} "
                        f"{rel:>9.2e} {TOL[dtype]:>7.0e} {ms:>9.3f} "
                        f"{plain_ms:>9.3f} {max(t_ops, t_bytes):>9.3f}")
                    # the JSON record: the main path's own launches (bf16,
                    # each width on the variant that serves it), summed
                    # over its generator calls
                    if dtype == torch.bfloat16 and rb.variant(C) == name:
                        s = summary.setdefault(name, dict(
                            ms=0.0, plain_ms=0.0, bound_ms=0.0, t_ops=0.0,
                            t_bytes=0.0, max_abs_err=0.0))
                        s["ms"] += n_calls * ms
                        s["plain_ms"] += n_calls * plain_ms
                        s["bound_ms"] += n_calls * max(t_ops, t_bytes)
                        s["t_ops"] += n_calls * t_ops
                        s["t_bytes"] += n_calls * t_bytes
                        s["max_abs_err"] = max(s["max_abs_err"], err)
                    del args
    torch.cuda.empty_cache()
    return summary


def load_prompts(n: int) -> list[str]:
    label = re.compile(r'"[^"]+"\s+"(?P<text>[^"]+)"')
    lines = []
    for line in (ROOT / "data" / "infer_text.txt").read_text().splitlines():
        m = label.match(line)
        text = m.group("text") if m else line
        if text.strip():
            lines.append(text)
    return lines[:n]


def make_pipe(compute_dtype):
    from tts_arabic_torch.infer import FastPitch2Wave
    pipe = FastPitch2Wave(seed=0, arabic_in=False,
                          compute_dtype=compute_dtype, device="cuda")
    # random init predicts ~0 frames per token; +2.0 gives ~6.5 (a
    # realistic Arabic speech rate at 86 frames/s)
    with torch.no_grad():
        pipe.model.model.duration_predictor.fc.bias.add_(2.0)
    return pipe


@contextlib.contextmanager
def generator_calls():
    """Records the mel shape of every HiFi-GAN generator call inside."""
    from tts_arabic_torch.vocoder.hifigan import Generator
    calls = []
    forward = Generator.forward

    def counted(self, mel):
        calls.append(tuple(mel.shape))
        return forward(self, mel)

    with mock.patch.object(Generator, "forward", counted):
        yield calls


def warm_run(pipe, prompts: list[str]) -> list[tuple]:
    """One untimed tts() (kernel build, cuDNN algorithm search, caching
    allocator); returns the generator calls' mel shapes, which phase 3
    times the kernels at."""
    with generator_calls() as calls:
        pipe.tts(prompts, batch_size=BATCH, denoise=0.005)
    torch.cuda.synchronize()
    return calls


def phase_main_path(pipe, prompts: list[str], shapes: list[tuple],
                    kernel_ms: float, smi: str) -> dict:
    from tts_arabic_torch.ops import resblock as rb
    torch.cuda.reset_peak_memory_stats()
    with generator_calls() as calls:
        rb.reset_launches()
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, batch_size=BATCH, denoise=0.005)
        wall = time.perf_counter() - t0
        launches = dict(rb.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    mels = pipe.model.ttmel(prompts, batch_size=BATCH)
    hop = pipe.hop_length
    for i, (w, m) in enumerate(zip(waves, mels)):
        if not (w.ndim == 1 and w.size > 0 and np.isfinite(w).all()):
            raise AssertionError(f"prompt {i}: empty or non-finite wave")
        if w.size != m.shape[1] * hop:
            raise AssertionError(f"prompt {i}: {w.size} samples, expected "
                                 f"{m.shape[1]} frames x {hop}")
    n_batches = -(-len(prompts) // BATCH)
    if len(calls) != n_batches or calls != shapes:
        raise AssertionError(f"generator calls {calls}, expected {n_batches}"
                             f" (one per batch) of the warm run's {shapes}")
    cfg = pipe.vocoder_config
    per_call = {"resblock1_wide": 0, "resblock1_narrow": 0}
    for i in range(len(cfg.upsample_rates)):
        ch = cfg.upsample_initial_channel // 2 ** (i + 1)
        name = rb.variant(ch)
        per_call[name] += len(cfg.resblock_kernel_sizes) * (
            len(DILATIONS) if name == "resblock1_wide" else 1)
    expected = {k: v * len(calls) for k, v in per_call.items()}
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    log(f"[4 main path] tts() of {len(prompts)} prompts, batch {BATCH}, "
        f"bf16: {audio_s:.2f} s of audio in {wall:.3f} s wall = "
        f"{audio_s / wall:.1f}x real time | generator calls (mel shapes) "
        f"{calls} | launches {launches} | ResBlock kernels at these shapes "
        f"(phase 3): {kernel_ms:.1f} ms = {kernel_ms / 10 / wall:.0f}% of "
        f"the wall | peak memory {peak_gb:.2f} GB | {smi}")
    return launches


def phase_generator_check(smi: str) -> None:
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    prompts = load_prompts(2)
    pipe = make_pipe(None)
    rb.reset_launches()
    kern = [pipe.tts_single(p, denoise=0.005) for p in prompts]
    if sum(rb.LAUNCHES.values()) == 0:
        raise AssertionError("f32 tts_single launched no kernel")
    with mock.patch.object(hifigan, "resblock1", rb.resblock1_plain):
        plain = [pipe.tts_single(p, denoise=0.005) for p in prompts]
    snrs = []
    for a, b in zip(kern, plain):
        assert a.shape == b.shape
        snrs.append(10 * np.log10(np.mean(b ** 2)
                                  / (np.mean((a - b) ** 2) + 1e-30)))
    log(f"[5 generator check] f32 tts_single x2, kernels vs plain "
        f"ResBlocks on the card: SNR {', '.join(f'{s:.1f}' for s in snrs)} "
        f"dB (> 40) | {smi}")
    if not min(snrs) > 40.0:
        raise AssertionError(f"SNR {min(snrs):.1f} dB <= 40")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import tts_arabic_torch  # noqa: F401  (fails outside the repo)
    torch.cuda.set_device(0)
    smi, name = phase_device()
    phase_build()
    prompts = load_prompts(N_PROMPTS)
    if len(prompts) != N_PROMPTS:
        raise AssertionError(f"{len(prompts)} prompts, expected {N_PROMPTS}")
    pipe = make_pipe(torch.bfloat16)
    shapes = warm_run(pipe, prompts)
    summary = phase_kernel_checks([f for _, f, _ in shapes])
    launches = phase_main_path(pipe, prompts, shapes,
                               sum(s["ms"] for s in summary.values()), smi)
    del pipe
    phase_generator_check(smi)
    replaces = {
        "resblock1_wide": "tts_arabic_tpu/ops/hifigan_pallas.py:153",
        "resblock1_narrow": "tts_arabic_tpu/ops/hifigan_pallas.py:547",
    }
    kernels = []
    for kname, s in summary.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "tts_arabic_torch/csrc/resblock1.cu",
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": ("operations" if s["t_ops"] >= s["t_bytes"]
                         else "bytes"),
            "library_ms": None})
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
