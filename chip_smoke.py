"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100): builds the CUDA kernels from `tts_arabic_torch/csrc`, holds every
kernel variant against its plain PyTorch version on the card, drives
`FastPitch2Wave.tts()` and FastPitch training (`apps.train_fastpitch`) at
full width, and checks what comes out.

    python3 chip_smoke.py

Phases, one line each (and a table for the kernel checks):
1. device: nvidia-smi's name and power limit, torch's device name
2. kernel build (nvcc, sm_90a), its seconds, and ptxas's registers, stack
   and spills for each kernel
   (then one untimed warm tts() of phase 4, which records the mel shapes
   of its generator calls)
3. kernel checks: resblock1 wide (C 256/128/64) and narrow (C 64/32),
   k 3/7/11, dilations 1/3/5, f32 (the CUDA-core kernels) and bf16 (the
   tensor-core kernels), at the main path's widths and
   stage lengths (each generator call's frames x the stage's samples per
   frame, batch 8), and once 3 rows shorter, which no tile divides, against
   `resblock1_plain`: f32 with TF32 off; bf16 against the plain version run
   in f32 on the same bf16 inputs. At the main path's lengths: the
   kernel's ms, the plain version's ms (same dtype) and the bound
4. main path: full-width FastPitch (d_model 384, 6+6 layers) + HiFi-GAN V1
   in bf16 on 16 prompts of data/infer_text.txt, batch 8, denoise 0.005,
   random weights from seed 0 with the duration head biased by +2.0; three
   tts() calls timed on the host clock, the first two re-warming the
   allocator (phase 3 empties its cache), the launch counters set to 0
   just before the third and read just after. Then one more tts() under
   torch.profiler (CUDA activity): the ResBlock kernels' device ms, the 8
   other device ops with the most device time, and the device's idle
   share of that call's wall
5. whole-generator checks: tts_single on 2 prompts through the kernels,
   then with the generator's ResBlocks on `resblock1_plain`: in f32 (SNR
   > 40 dB), and in bf16 against the plain ResBlocks run in f32 on each
   stage's bf16 input (SNR > 35.99 dB, the CUDA-core kernels' 38.99 dB
   less 3)
   (then a synthetic corpus for the training slice is written to a temp
   dir under build/ from seed 0: the first 60 lines of
   data/train_phon.txt with at most 140 symbols and 10 of
   data/test_phon.txt, each a voiced tone with its own f0 contour plus
   noise, 7 mel frames per symbol, its true f0 in a `pitch_dict.npz`, and
   a config with configs/nawar_fp.yaml's values)
6. MAS kernel checks: `ops.mas.mas_fused` against `align.mas.mas` on the
   card, at each collated shape of the training run's batches (their own
   lengths, random log-attention) and at [10, 1024, 256], a ragged
   [4, 1000, 300] with rows where out_len < in_len, [6, 1850, 368], a
   text past one warp's 1024 columns [2, 40, 2100], and two shapes whose
   direction bits spill from shared memory to the global scratch,
   [2, 6000, 1200] and bucket 4's [1, 30000, 4300]; max |kernel - plain|
   must be 0 and the durations equal. Each row prints where its bits went
   (shared memory or spilled) and the kernel's ms; at the training
   batches also the first kernel's ms at the same batch (its reading in
   `PERF.md`), the plain version's ms and the byte bound
7. training: `apps.train_fastpitch.main` at full width (FastPitchConfig())
   on that corpus, one epoch (6 steps of batch 10, T_mel <= 1024), then
   validation; PyTorch's default precision (cuDNN TF32 on, matmul TF32
   off). The launch counters are set to 0 just before and read just after.
   Checks: finite losses, every trained parameter moved, MAS launches =
   steps + validation batches, the MAS calls' shapes = phase 6's, and the
   checkpoint reloads into a fresh Trainer with identical parameters.
   Prints each step's loss and time, steps/s over steps 2-6 (host clock,
   synchronized), the MAS kernel's share of those steps (phase 6's times)
   and the peak device memory. Then one more step at the first batch (a
   shape met before) under torch.profiler: MAS's device ms and share of the
   step's device time, the device's idle share of the step's wall, and the
   8 device ops with the most device time
8. whole-step check: one f32 train step (TF32 off, cuDNN deterministic)
   from one state, batch and dropout seed, with MAS on the kernel and then
   on the plain version; equal losses, gradients within 1e-5 of their norm

Then nvidia-smi's line again, the kernels' JSON record (for each ResBlock
variant its ms, plain_ms and bound_ms summed over the serving path's bf16
launches, as timed in phase 3; for MAS the same sums over the training
run's launches, as timed in phase 6), and last the result line. Any
failure raises and the exit code is not 0; without a CUDA device the
script exits 1 before printing any result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DILATIONS = (1, 3, 5)
KERNEL_SIZES = (3, 7, 11)
N_PROMPTS = 16
BATCH = 8
N_TIMED = 3             # timed tts() calls in phase 4, the last counted
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# kernel vs plain: max |kernel - plain| <= TOL * max |plain|. f32: the two
# differ by summation order only; bf16: the kernel rounds each conv output
# and residual to bf16 (as the TPU kernel rounds to x.dtype), the plain
# reference runs in f32
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# phase 5, whole-generator SNR (dB) of the kernels against the plain
# ResBlocks: f32 differs by summation order; bf16 (against the plain
# version in f32) is the CUDA-core kernels' reading, 38.99 dB on an H100,
# less 3 dB
SNR_GATE = {torch.float32: 40.0, torch.bfloat16: 35.99}
WIDE_CHANNELS = (256, 128, 64)
NARROW_CHANNELS = (64, 32)
STAGE_T = {256: 8, 128: 64, 64: 128, 32: 256}   # samples per mel frame
# the training slice's synthetic corpus
N_TRAIN, N_VAL = 60, 10
MAX_SYMBOLS = 140       # 980 frames at most: every utterance in bucket 1
FRAMES_PER_SYMBOL = 7
SAMPLE_RATE, HOP = 22050, 256
# MAS checks beyond the training batches: [B, T_mel, T_txt]
MAS_SHAPES = {"full": (10, 1024, 256), "ragged": (4, 1000, 300),
              "bucket 3": (6, 1850, 368), "long text": (2, 40, 2100),
              "spilled": (2, 6000, 1200), "bucket 4": (1, 30000, 4300)}
# the first MAS kernel (one warp per batch row) at the training run's
# batches, ms a call (PERF.md section 6; H100 80GB HBM3, 700 W)
FIRST_MAS_MS = {"train 0": 0.384, "train 1": 0.313, "train 2": 0.352,
                "train 3": 0.263, "train 4": 0.178, "train 5": 0.347,
                "val 0": 0.318}
GRAD_TOL = 1e-5         # phase 8: |g_kernel - g_plain| / |g_plain|


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


def tf32_state() -> str:
    return (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cuDNN {torch.backends.cudnn.allow_tf32}")


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


def ptxas_lines(build_log: str) -> list[str]:
    """ptxas's register and spill lines, one per kernel, each after the
    kernel's name and template arguments."""
    out, name = {}, "?"
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:resblock1|mas)"
                      r"\w*?kernel)(I\w*?E)?E", ln)
        if m:
            targs = m.group(2) or ""
            args = re.findall(r"Li(\d+)E", targs) or (
                ["float"] if targs == "IfE" else [])
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        elif re.search(r"registers|spill", ln):
            out.setdefault(name, []).append(
                ln.split(":", 1)[-1].strip() if "Used" in ln else ln.strip())
    return [f"{n}: {'; '.join(v)}" for n, v in out.items()]


def phase_build() -> None:
    from tts_arabic_torch.ops import build
    t0 = time.perf_counter()
    build.library()
    took = time.perf_counter() - t0
    srcs = ", ".join(p.name for p in sorted(build.CSRC.glob("*.cu")))
    log(f"[2 build] {srcs} -> sm_90a in {took:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s, one process per source)")
    for ln in ptxas_lines(build.build_log):
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
    """N_TIMED tts() calls of the prompts, each timed on the host clock:
    the first ones re-warm the allocator (phase 3 emptied its cache), the
    last is the main path's run, with the launch counters set to 0 just
    before it and read just after."""
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(N_TIMED - 1):
        t0 = time.perf_counter()
        pipe.tts(prompts, batch_size=BATCH, denoise=0.005)
        walls.append(time.perf_counter() - t0)
    with generator_calls() as calls:
        rb.reset_launches()
        mas_ops.reset_launches()
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, batch_size=BATCH, denoise=0.005)
        walls.append(time.perf_counter() - t0)
        launches = dict(rb.LAUNCHES)
        mas_launches = mas_ops.LAUNCHES["mas"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if mas_launches:
        raise AssertionError(f"tts() launched the MAS kernel {mas_launches} "
                             "times: MAS is training-only")

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
    wall = walls[-1]
    log(f"[4 main path] tts() of {len(prompts)} prompts, batch {BATCH}, "
        f"bf16: {audio_s:.2f} s of audio in {wall:.3f} s wall = "
        f"{audio_s / wall:.1f}x real time (the {N_TIMED} calls: "
        f"{', '.join(f'{w:.3f}' for w in walls)} s, the first after phase 3 "
        f"emptied the allocator's cache) | generator calls (mel shapes) "
        f"{calls} | launches {launches}, mas 0 | ResBlock kernels at these "
        f"shapes (phase 3): {kernel_ms:.1f} ms = {kernel_ms / 10 / wall:.0f}"
        f"% of the wall | peak memory {peak_gb:.2f} GB | {smi}")
    return launches


def _plain_f32(x, w1, b1, w2, b2, k, dilations):
    """`resblock1_plain` in f32 on the stage's own input and the weights
    the kernel reads (rounded to x's dtype); the result in x's dtype."""
    from tts_arabic_torch.ops import resblock as rb
    w1, w2 = (w.to(x.dtype).float() for w in (w1, w2))
    return rb.resblock1_plain(x.float(), w1, b1.float(), w2, b2.float(), k,
                              dilations).to(x.dtype)


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void ", "", name).split("(")[0][:60]


def profiled(fn):
    """fn() under torch.profiler (CUDA activity only), ending in a
    synchronize: (wall s on the host clock, device ms by op name, device
    busy ms, number of device ops), or None where no device event was
    recorded. The profiler's own host cost counts as idle."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    by_name = collections.Counter()
    for name, s, e in dev:
        by_name[_short(name)] += (e - s) / 1e3
    busy, (lo, hi) = 0.0, sorted((s, e) for _, s, e in dev)[0]
    for s, e in sorted((s, e) for _, s, e in dev):
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    return wall, by_name, (busy + hi - lo) / 1e3, len(dev)


def profile_tts(pipe, prompts: list[str], smi: str) -> None:
    """One more tts() of phase 4's prompts under torch.profiler, apart from
    the timed one: the ResBlock kernels' device ms, the 8 other device ops
    with the most device time, and the device's idle share of the call's
    wall."""
    got = profiled(lambda: pipe.tts(prompts, batch_size=BATCH,
                                    denoise=0.005))
    if got is None:
        log(f"[4 profile] tts() under torch.profiler: no device events "
            f"recorded, breakdown not measured | {smi}")
        return
    wall, by_name, busy, n_ops = got
    rb_ms = sum(v for n, v in by_name.items() if "resblock1" in n)
    top = [(n, v) for n, v in by_name.most_common() if "resblock1" not in n]
    log(f"[4 profile] tts() under torch.profiler: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms (idle {100 * (1 - busy / 1e3 / wall):.1f}"
        f"% of the wall), {n_ops} device ops summing "
        f"{sum(by_name.values()):.1f} ms | ResBlock kernels {rb_ms:.2f} ms | "
        f"top others: " + "; ".join(f"{n} {v:.2f} ms" for n, v in top[:8])
        + f" | {smi}")


def profile_step(state, batch: dict, smi: str) -> None:
    """One more train step of `state` at `batch`, a shape the run has met,
    once unprofiled and then under torch.profiler: MAS's device ms and
    share of the step's device time, the device's idle share of the step's
    wall, and the 8 device ops with the most device time."""
    from tts_arabic_torch.train import steps
    step = steps.make_fastpitch_train_step(device="cuda")
    step(state, batch, 1)
    got = profiled(lambda: step(state, batch, 2))
    shape = tuple(batch["attn_prior"].shape)
    if got is None:
        log(f"[7 profile] train step at {shape} under torch.profiler: no "
            f"device events recorded, breakdown not measured | {smi}")
        return
    wall, by_name, busy, n_ops = got
    dev_ms = sum(by_name.values())
    mas_ms = sum(v for n, v in by_name.items() if "mas_kernel" in n)
    log(f"[7 profile] one steady train step at {shape} under "
        f"torch.profiler: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} "
        f"ms (idle {100 * (1 - busy / 1e3 / wall):.1f}% of the wall), "
        f"{n_ops} device ops summing {dev_ms:.1f} ms | MAS kernel "
        f"{mas_ms:.4f} ms = {100 * mas_ms / dev_ms:.3f}% of the device time "
        f"| top: " + "; ".join(f"{n} {v:.2f} ms"
                               for n, v in by_name.most_common(8))
        + f" | {smi}")


def phase_generator_check(smi: str, dtype) -> list[float]:
    """tts_single on 2 prompts through the kernels, then with every
    generator ResBlock on the plain version (f32: as is, TF32 off; bf16:
    `_plain_f32`); the SNR of the waves, gated at SNR_GATE[dtype]."""
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    set_tf32(False)
    dname = str(dtype).removeprefix("torch.")
    prompts = load_prompts(2)
    pipe = make_pipe(None if dtype == torch.float32 else dtype)
    rb.reset_launches()
    kern = [pipe.tts_single(p, denoise=0.005) for p in prompts]
    if sum(rb.LAUNCHES.values()) == 0:
        raise AssertionError(f"{dname} tts_single launched no kernel")
    plain_rb = rb.resblock1_plain if dtype == torch.float32 else _plain_f32
    with mock.patch.object(hifigan, "resblock1", plain_rb):
        plain = [pipe.tts_single(p, denoise=0.005) for p in prompts]
    snrs = []
    for a, b in zip(kern, plain):
        assert a.shape == b.shape
        snrs.append(10 * np.log10(np.mean(b ** 2)
                                  / (np.mean((a - b) ** 2) + 1e-30)))
    log(f"[5 generator check] {dname} tts_single x2, kernels vs plain "
        f"ResBlocks{' in f32' if dtype != torch.float32 else ''} on the "
        f"card: SNR {', '.join(f'{s:.2f}' for s in snrs)} dB "
        f"(> {SNR_GATE[dtype]}) | {smi}")
    if not min(snrs) > SNR_GATE[dtype]:
        raise AssertionError(f"{dname} SNR {min(snrs):.2f} dB <= "
                             f"{SNR_GATE[dtype]}")
    return snrs


# ---- the training slice ------------------------------------------------------

def _voiced_tone(rng, n_frames: int):
    """A voiced tone (fundamental + 2nd harmonic) with a slow f0 contour
    around a per-utterance base, plus noise; returns (wave, f0 at each mel
    frame's centre)."""
    n = n_frames * HOP
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(100.0, 170.0) * (1.0 + 0.08 * np.sin(
        2 * np.pi * rng.uniform(0.3, 1.2) * t + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    wave = (0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase)
            + 0.02 * rng.standard_normal(n))
    # frame i spans samples [i*HOP - 384, i*HOP + 640) (reflect-padded)
    centres = np.arange(n_frames) * HOP + HOP // 2
    return wave.astype(np.float32), f0[centres].astype(np.float32)


def write_corpus(root: pathlib.Path) -> pathlib.Path:
    """The synthetic corpus and its config (see the module docstring);
    returns the config's path."""
    from tts_arabic_torch import text
    from tts_arabic_torch.audio.io import save_wav
    from tts_arabic_torch.data.dataset import (DEFAULT_LABEL_PATTERN,
                                               parse_label_line)
    from tts_arabic_torch.runtime.config import load_yaml
    rng = np.random.default_rng(0)
    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    f0_dict = {}
    for split, src, n in (("train", "train_phon.txt", N_TRAIN),
                          ("test", "test_phon.txt", N_VAL)):
        lines = []
        for line in (ROOT / "data" / src).read_text().splitlines():
            if len(lines) == n:
                break
            if not line.strip():
                continue
            phonemes, name = parse_label_line(DEFAULT_LABEL_PATTERN, line)
            n_sym = len(text.tokens_to_ids(text.phonemes_to_tokens(phonemes)))
            if n_sym > MAX_SYMBOLS:
                continue
            wave, f0 = _voiced_tone(rng, FRAMES_PER_SYMBOL * n_sym)
            save_wav(wavs / name, wave, SAMPLE_RATE)
            f0_dict[name] = f0
            lines.append(line)
        if len(lines) != n:
            raise AssertionError(f"{src}: {len(lines)} lines, expected {n}")
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    np.savez(root / "pitch_dict.npz", **f0_dict)
    cfg = load_yaml(ROOT / "configs" / "nawar_fp.yaml")
    cfg.update(log_dir=str(root / "logs"), checkpoint_dir=str(root / "ckpt"),
               train_wavs_path=str(wavs), train_labels=str(root / "train.txt"),
               test_wavs_path=str(wavs), test_labels=str(root / "test.txt"),
               f0_dict_path=str(root / "pitch_dict.npz"))
    path = root / "nawar_fp_smoke.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in cfg.items()))
    return path


def training_batches(config_path) -> tuple[list, list]:
    """The collated batches of the training run, in its order (the CLI's
    datasets and buckets, with the reshuffle `Trainer.fit` makes at the
    start of the epoch), and its validation batches."""
    from tts_arabic_torch.data import (ArabDatasetFastPitch, DynBatchDataset,
                                       collate_fastpitch)
    from tts_arabic_torch.runtime.config import get_config
    cfg = get_config(config_path)
    out = []
    for labels, wavs, epoch_shuffle in (
            (cfg.train_labels, cfg.train_wavs_path, True),
            (cfg.test_labels, cfg.test_wavs_path, False)):
        ds = ArabDatasetFastPitch(
            labels, wavs, label_pattern=cfg.label_pattern,
            f0_dict_path=cfg.get_path("f0_dict_path"), f0_mean=cfg.f0_mean,
            f0_std=cfg.f0_std)
        dyn = DynBatchDataset(ds, max_lengths=cfg.max_lengths,
                              batch_sizes=cfg.batch_sizes)
        if epoch_shuffle:
            dyn.shuffle()
        out.append([collate_fastpitch(dyn[i]) for i in range(len(dyn))])
    return out[0], out[1]


def mas_bound_ms(shape, in_lens, out_lens) -> float:
    """Least time for one MAS call: the valid region of log_attn read once
    (what this call's lengths need), the [B, T_mel, T_txt] f32 output and
    the lengths written/read once, at the memory rate. The operations
    (add, max, compare per valid cell) take under 1% of that at the f32
    rate, so the bytes bound it."""
    B, T_mel, T_txt = shape
    valid = sum(min(int(o), T_mel) * int(i) for i, o in zip(in_lens, out_lens))
    return (4 * valid + 4 * B * T_mel * T_txt + 8 * B) / PEAK_BYTES * 1e3


def _mas_inputs(shape, gen, in_lens=None, out_lens=None):
    """Random log-softmaxed scores on the card; lengths as given, else
    random in [1, T] with row 0 at full size and, where the shape allows,
    a row with out_len < in_len (no monotonic path)."""
    B, T_mel, T_txt = shape
    log_attn = torch.log_softmax(3.0 * torch.randn(
        shape, generator=gen, device="cuda"), dim=-1)
    if in_lens is None:
        in_lens = torch.randint(1, T_txt + 1, (B,), generator=gen,
                                device="cuda")
        out_lens = torch.randint(1, T_mel + 1, (B,), generator=gen,
                                 device="cuda")
        in_lens[0], out_lens[0] = T_txt, T_mel
        if B > 1:
            in_lens[1], out_lens[1] = T_txt, max(1, min(T_mel, T_txt) - 7)
    else:
        in_lens = torch.as_tensor(in_lens, device="cuda")
        out_lens = torch.as_tensor(out_lens, device="cuda")
    return log_attn, in_lens.to(torch.int32), out_lens.to(torch.int32)


def _mas_check(inputs, label: str) -> float:
    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.ops import mas as mas_ops
    log_attn, in_lens, out_lens = inputs
    got = mas_ops.mas_fused(*inputs)
    ref = mas_plain(*inputs)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if err != 0.0 or not torch.equal(got.sum(1), ref.sum(1)):
        raise AssertionError(f"MAS {label}: kernel differs from the plain "
                             f"version (max abs err {err})")
    frames = torch.clamp(out_lens, max=log_attn.shape[1]).to(got.dtype)
    if not torch.equal(got.sum((1, 2)), frames):
        raise AssertionError(f"MAS {label}: not one text position per frame")
    return err


def _mas_bits(shape) -> str:
    """Where the kernel keeps a shape's direction bits."""
    from tts_arabic_torch.ops import build
    words = build.library().mas_scratch_words(shape[1], shape[2])
    return "spilled" if words > 0 else "shared"


def phase_mas_checks(train: list, val: list) -> dict:
    """Bit-equality at every shape, with the kernel's time; at the training
    run's batches also the first kernel's time at the same batch, the plain
    version's time and the bound."""
    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.ops import mas as mas_ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    log("[6 MAS kernel checks] kernel vs plain MAS on the card, err = "
        "max|kernel - plain| (must be 0), durations equal; bits: where the "
        "direction bits went; first_ms: the first kernel at the same batch")
    log(f"    {'case':12} {'B':>3} {'T_mel':>6} {'T_txt':>6} {'bits':>7} "
        f"{'err':>4} {'ms':>8} {'first_ms':>9} {'plain_ms':>9} "
        f"{'bound_ms':>9}")
    rows, max_err = [], 0.0
    for label, batch in ([(f"train {i}", b) for i, b in enumerate(train)]
                         + [(f"val {i}", b) for i, b in enumerate(val)]):
        shape = tuple(batch["attn_prior"].shape)
        inputs = _mas_inputs(shape, gen, batch["token_lens"],
                             batch["mel_lens"])
        err = _mas_check(inputs, label)
        max_err = max(max_err, err)
        row = dict(label=label, shape=shape,
                   ms=cuda_ms(lambda: mas_ops.mas_fused(*inputs)),
                   plain_ms=cuda_ms(lambda: mas_plain(*inputs)),
                   bound_ms=mas_bound_ms(shape, batch["token_lens"],
                                         batch["mel_lens"]))
        rows.append(row)
        log(f"    {label:12} {shape[0]:>3} {shape[1]:>6} {shape[2]:>6} "
            f"{_mas_bits(shape):>7} {err:>4g} {row['ms']:>8.3f} "
            f"{FIRST_MAS_MS.get(label, math.nan):>9.3f} "
            f"{row['plain_ms']:>9.3f} {row['bound_ms']:>9.5f}")
    for label, shape in MAS_SHAPES.items():
        inputs = _mas_inputs(shape, gen)
        err = _mas_check(inputs, label)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: mas_ops.mas_fused(*inputs))
        log(f"    {label:12} {shape[0]:>3} {shape[1]:>6} {shape[2]:>6} "
            f"{_mas_bits(shape):>7} {err:>4g} {ms:>8.3f}")
        del inputs
    total, first = (sum(r["ms"] for r in rows),
                    sum(FIRST_MAS_MS.get(r["label"], math.nan) for r in rows))
    log(f"    the training run's {len(rows)} calls: {total:.3f} ms, the "
        f"first kernel {first:.3f} ms, plain "
        f"{sum(r['plain_ms'] for r in rows):.1f} ms, bound "
        f"{sum(r['bound_ms'] for r in rows):.5f} ms")
    torch.cuda.empty_cache()
    return dict(rows=rows, max_abs_err=max_err)


def _unmoved(trained: torch.nn.Module, init: torch.nn.Module) -> list:
    """Names of the parameters that did not move from `init`."""
    init_p = dict(init.named_parameters())
    return [n for n, p in trained.named_parameters()
            if torch.equal(p.detach().cpu(), init_p[n].detach())]


def phase_training(config_path, train: list, val: list, mas: dict,
                   smi: str) -> dict:
    from tts_arabic_torch.apps import train_fastpitch
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.train import steps
    from tts_arabic_torch.train.trainer import Trainer
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    times, losses, mas_shapes = [], [], []
    make_step, fused = train_fastpitch.make_fastpitch_train_step, \
        mas_ops.mas_fused

    def timed_step(**kw):
        step = make_step(**kw)

        def run(state, batch, seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta = step(state, batch, seed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(meta["loss"]))
            return meta
        return run

    def recorded(log_attn, in_lens, out_lens):
        mas_shapes.append(tuple(log_attn.shape))
        return fused(log_attn, in_lens, out_lens)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_fastpitch, "make_fastpitch_train_step",
                           timed_step), \
            mock.patch.object(mas_ops, "mas_fused", recorded):
        rb.reset_launches()
        mas_ops.reset_launches()
        trainer = train_fastpitch.main([
            "--config", str(config_path), "--epochs", "1", "--log-every",
            "1", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = {**rb.LAUNCHES, **mas_ops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_steps = len(train)
    for i, (loss, t) in enumerate(zip(losses, times)):
        log(f"    step {i + 1}: loss {loss:.4f}, {t * 1e3:.1f} ms")
    if len(times) != n_steps or trainer.state.step != n_steps:
        raise AssertionError(f"{len(times)} steps timed, state at step "
                             f"{trainer.state.step}, expected {n_steps}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = [tuple(b["attn_prior"].shape) for b in train + val]
    if mas_shapes != want:
        raise AssertionError(f"MAS calls at {mas_shapes}, phase 6 checked "
                             f"{want}")
    if launches["mas"] != len(train) + len(val):
        raise AssertionError(f"MAS launches {launches['mas']}, expected "
                             f"{len(train)} steps + {len(val)} validation "
                             "batches")
    cfg = trainer.state.model.config
    init = init_weights(FastPitch(FastPitchConfig()), trainer.seed)
    still = _unmoved(trainer.state.model, init)
    if any(not n.startswith("attention.attn_proj") for n in still):
        raise AssertionError(f"parameters that did not move: {still}")
    rows = [json.loads(ln) for ln in (pathlib.Path(
        trainer.logger.log_dir) / "metrics.jsonl").read_text().splitlines()]
    val_loss = [r["val/loss"] for r in rows if "val/loss" in r]
    if len(val_loss) != 1 or not math.isfinite(val_loss[0]):
        raise AssertionError(f"validation losses {val_loss}")

    fresh_model = FastPitch(cfg).to("cuda")
    fresh = Trainer(steps.make_fastpitch_train_step(device="cuda"),
                    steps.TrainState(fresh_model,
                                     steps.make_optimizer(fresh_model)),
                    log_dir=pathlib.Path(config_path).parent / "logs_restore",
                    checkpoint_dir=trainer.ckpt.directory, device="cuda")
    restored = fresh.restore()
    fresh.close()
    trained_sd = trainer.state.model.state_dict()
    differ = [n for n, v in fresh_model.state_dict().items()
              if not torch.equal(v, trained_sd[n])]
    if restored != n_steps or differ:
        raise AssertionError(f"checkpoint restored step {restored}, "
                             f"entries that differ: {differ}")

    steady = times[1:]
    mas_ms = sum(r["ms"] for r in mas["rows"][1:n_steps])
    # a batch shape the run has not met before costs more (cuDNN plans,
    # allocator growth): the steps at a shape met before, apart
    repeat = [t for i, t in enumerate(times) if want[i] in want[:i]]
    repeat_msg = (f"{len(repeat)} at a shape met before: "
                  f"{sum(repeat) / len(repeat) * 1e3:.1f} ms a step"
                  if repeat else "no shape met twice")
    log(f"[7 training] train_fastpitch.main, FastPitchConfig() (d_model "
        f"{cfg.d_model}, {cfg.enc_n_layers}+{cfg.dec_n_layers} FFT layers, "
        f"filter {cfg.enc_filter_size}), nawar_fp.yaml recipe, f32, "
        f"{tf32_state()}: {n_steps} steps of batch "
        f"{sorted({s[0] for s in want[:n_steps]})} (T_mel <= "
        f"{max(s[1] for s in want[:n_steps])}) + {len(val)} validation "
        f"batch(es), val loss {val_loss[0]:.4f} | steps 2-{n_steps}: "
        f"{len(steady) / sum(steady):.2f} steps/s, "
        f"{sum(steady) / len(steady) * 1e3:.1f} ms a step ({repeat_msg}), "
        f"MAS kernel "
        f"{mas_ms / len(steady):.3f} ms a step = "
        f"{100 * mas_ms / (sum(steady) * 1e3):.2f}% (phase 6 times) | "
        f"launches {launches} | checkpoint step {restored} reloads equal | "
        f"peak memory {peak_gb:.2f} GB | {smi}")
    profile_step(trainer.state, train[0], smi)
    return launches


def phase_step_check(batch: dict, smi: str) -> None:
    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.models.fastpitch import FastPitch
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.train import steps
    set_tf32(False)
    torch.backends.cudnn.deterministic = True
    base = init_weights(FastPitch(), 0).to("cuda")
    runs = {}
    for route in ("kernel", "plain"):
        model = copy.deepcopy(base)
        state = steps.TrainState(model, steps.make_optimizer(model))
        step = steps.make_fastpitch_train_step(device="cuda")
        plain = (mock.patch.object(mas_ops, "mas_fused", mas_plain)
                 if route == "plain" else contextlib.nullcontext())
        mas_ops.reset_launches()
        with plain:
            meta = step(state, batch, 0)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        runs[route] = (float(meta["loss"]), grads, mas_ops.LAUNCHES["mas"])
    torch.backends.cudnn.deterministic = False
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = runs["kernel"], runs["plain"]
    diff = math.sqrt(sum(float((g_k[n] - g).pow(2).sum())
                         for n, g in g_p.items()))
    norm = math.sqrt(sum(float(g.pow(2).sum()) for g in g_p.values()))
    log(f"[8 whole-step check] one f32 train step, {tf32_state()}, cuDNN "
        f"deterministic, batch {tuple(batch['attn_prior'].shape)}: loss "
        f"{loss_k!r} (MAS kernel, {n_k} launch) vs {loss_p!r} (plain, "
        f"{n_p}) | |g_kernel - g_plain| = {diff:.3e} of |g| = {norm:.3e} "
        f"(<= {GRAD_TOL:.0e}) over {len(g_p)} tensors | {smi}")
    if (n_k, n_p) != (1, 0):
        raise AssertionError(f"MAS launches kernel {n_k}, plain {n_p}")
    if loss_k != loss_p or g_k.keys() != g_p.keys():
        raise AssertionError("the two steps' losses or gradients differ")
    if not diff <= GRAD_TOL * norm:
        raise AssertionError(f"gradient difference {diff} > {GRAD_TOL} x "
                             f"{norm}")


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
    profile_tts(pipe, prompts, smi)
    del pipe
    phase_generator_check(smi, torch.float32)
    phase_generator_check(smi, torch.bfloat16)
    build_dir = ROOT / "build"      # git-ignored, inside the checkout
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_corpus_",
                                     dir=build_dir) as tmp:
        config_path = write_corpus(pathlib.Path(tmp))
        train, val = training_batches(config_path)
        mas = phase_mas_checks(train, val)
        train_launches = phase_training(config_path, train, val, mas, smi)
        phase_step_check(train[0], smi)
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
    # one MAS launch per training step and validation batch, each timed at
    # its own batch's shape in phase 6
    kernels.append({
        "name": "mas", "route": "cuda",
        "source": "tts_arabic_torch/csrc/mas.cu",
        "replaces": "tts_arabic_tpu/ops/mas_pallas.py:98",
        "launches": train_launches["mas"],
        "max_abs_err": mas["max_abs_err"],
        **{k: sum(r[k] for r in mas["rows"])
           for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None})
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
