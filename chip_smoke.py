"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an
H100): builds the CUDA kernels from `tts_arabic_torch/csrc`, holds every
kernel variant against its plain PyTorch version on the card, drives
`FastPitch2Wave.tts()`, FastPitch training (`apps.train_fastpitch`), the
serving surface (`stream()`, long-form, the vowelizers, the HTTP server
and the inference CLI), `Tacotron2Wave` (tts(), its decode, stream(),
the CLI and the server), the int8 path of both pipelines, the Vocos
vocoder, the adversarial FastPitch recipe, Tacotron2 training (MSE and
adversarial), HiFi-GAN vocoder training, the AOT serving bundles
(`torch.export`), the offline apps, a gate-controlled Tacotron2
(`eval.gate_control`) and the parallel layer (data, sequence and tensor
parallelism on two ranks that share the card) at full width, and checks
what comes out.

    python3 chip_smoke.py

Phases, one line each (and a table for the kernel checks):
1. device: nvidia-smi's name and power limit, torch's device name
2. kernel build (nvcc, sm_90a), its seconds, ptxas's registers, stack
   and spills for each kernel, and each ResBlock kernel's tensor-core
   instructions in the library's SASS (`cuobjdump -sass`: every f32
   kernel must run TF32 HMMA, every bf16 kernel BF16 HMMA)
   (then one untimed warm tts() of phase 4, which records the mel shapes
   of its generator calls)
3. kernel checks: resblock1 wide (C 256/128/64) and narrow (C 64/32),
   k 3/7/11, dilations 1/3/5, f32 (the 3xTF32 tensor-core kernels) and
   bf16 (the bf16 tensor-core kernels), at the main path's widths and
   stage lengths (each generator call's rows, and its frames x the stage's
   samples per frame), and once 3 rows shorter, which no tile divides, against
   `resblock1_plain`: f32 with TF32 off; bf16 against the plain version run
   in f32 on the same bf16 inputs. At the main path's lengths: the
   kernel's ms, the plain version's ms (same dtype), the bound (f32: the
   operations at 3xTF32's 165 TFLOP/s, and beside it at the CUDA cores'
   67) and the bound's share of the kernel's time
4. main path: full-width FastPitch (d_model 384, 6+6 layers) + HiFi-GAN V1
   in bf16 on 16 prompts of data/infer_text.txt, batch 8, denoise 0.005,
   random weights from seed 0 with the duration head biased by +2.0; three
   tts() calls timed on the host clock, the first two re-warming the
   allocator (phase 3 empties its cache), the launch counters set to 0
   just before the third and read just after; the generator calls are the
   length groups (`vocoder.hifigan.length_groups`) of each batch's rows,
   27 wide + 3 narrow launches each. Then one more tts() under
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
   validation without its figures (`--no-figures`: the card's machine
   has no matplotlib; so in phases 17-18); PyTorch's default precision (cuDNN TF32 on, matmul TF32
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
9. streaming, phase 4's configuration: the bf16 ResBlock kernels at one
   streamed window's shapes (B = 1, 160 frames) against the plain version,
   with ms, plain ms and bound summed per chunk; then `capture_graphs()`
   (its seconds and device memory), and `stream()` of the first 4 or more
   prompts joined (8 chunks at least; chunks of 128 frames, overlap 16)
   against `tts_single`, both replaying the one-row encode and decoder
   graphs: equal lengths, SNR > STREAM_BF16_SNR against the graphed and
   the eager `tts_single`, 27 wide and 3 narrow launches per vocoded window
   (counters set to 0 just before the stream, read just after), every
   ResBlock call of a stream and of the clamped last window against the
   plain version, the speculation fallback (STREAM_SPEC_FRAMES = 1), int16
   and mu-law chunks, the host cost of the per-call weight lookups, time to
   the first chunk against the whole `tts_single` (3 runs each, host
   clock; first < 0.75 x whole with the graphs on both sides; the same
   pair with the tokenizer's word cache emptied before each call, and
   eagerly, printed beside it), then one request for each of the 16
   prompts at mixed speeds and pitches, its words met nowhere before
   (first chunk and whole call, each stream against the eager
   `tts_single` of its text and rate), and
   `tts_long` of the 16 prompts; then in f32, max |stream - tts_single|
   <= 1e-4 with and without the speculation, and the graphed
   `tts_single` against the eager
10. vowelizers: seeded Shakkala and Shakkelha on the card, `predict` of 16
   lines of data/test_arab.txt (diacritics stripped) batched against one
   by one (equal strings, |dprob| <= 1e-5), then `tts(lines,
   vowelizer="shakkelha")` with predict's share of the time
11. apps: the port's HTTP server on 127.0.0.1 (a free port, a thread)
   with a one-entry full-width bf16 registry, after `warmup()`: `/api/tts`
   writes its wav, `/api/tts/stream` of each of the 16 prompts at mixed
   rates gives the bytes of the model's own `stream()`, with the time to
   the first byte of each; then the inference CLI on
   the 16 prompts from a `states.ckpt` into a temp dir under build/,
   within 1 LSB of the served model's `tts()`
12. Tacotron2: full-width Tacotron2 (Tacotron2Config(): 512-wide encoder,
   1024-wide attention and decoder LSTMs, k31 location conv, postnet 5 x
   512) and HiFi-GAN V1, both f32 (TF32 off), seeded random weights (seed
   0), the 16 prompts, batch 8, decoder_max_step 3000 (the random gate
   never fires, so both batches decode 3000 steps), denoise 0.005:
   `warmup()` capturing the decode-block graphs of the two batches'
   shapes (seconds, memory); three timed tts() calls, the launch counters
   set to 0 just before the third and read just after (27 wide + 3
   narrow per generator call, MAS 0), each prompt's frames; the decode
   alone of the second batch, graphed (3000 steps) and eager (300 steps),
   wall and device us a step against the step's bound (the decoder's f32
   weights read once at the memory rate), and each under torch.profiler
   (idle share, device time and ops a step, top ops); a DECODE_BLOCK
   sweep (4-64 steps a block, graphed, 600 steps); that batch again with
   the gate set from its capped decode's logits so its rows stop at
   distinct steps (graphed = eager, lengths as the logits predict); one
   tts() under torch.profiler (the ResBlock kernels' share of device
   time and wall, beside their 3xTF32 and CUDA-core bounds); the fused
   device path against the host path on the first batch (within 1e-4),
   the kernels against the plain ResBlocks on those mels (SNR > 40 dB);
   the f32 kernels at the counted tts()'s stage shapes (seeded inputs,
   within 1e-4 of the plain version) timed beside the plain version
   (cuDNN f32, TF32 off) with both bounds; stream() of the shortest
   prompt against tts_single(postprocess_mel=False) (within 1e-4) with
   the time to its first chunk against the whole call (min of 3, graphs
   on both sides)
13. Tacotron2 apps: the inference CLI with --model tacotron2 on 8 prompts
   from a reference `.pth` (f32, eager decode) within 1 LSB of the same
   weights' tts(speed=1.0); the server with a one-entry `tacotron2`
   registry after its warmup(): /api/tts, /api/tts/stream equal to the
   model's stream() (replaying the warmed graph), and a 400 for rate 1.25
14. int8, FastPitch: FastPitch2Wave(quantize="int8"), phase 4's
   configuration (bf16, seeded, duration bias +2.0 before the
   constructor calibrates on the built-in texts: 54 MRF sites, 6 decoder
   FFN layers), warmup(), three timed tts() of the 16 prompts (the launch
   counters set to 0 just before the last: 0 wide, 3 narrow launches per
   generator call, MAS 0), the real-time factor beside phase 4's; one
   tts() under torch.profiler (idle share, device time), and every
   `int8_conv_static` call of one more timed alone at its shape with CUDA
   events (their share of that device time); every int8 conv of one tts()
   against the float64 conv
   of its int8 grids (equal int32 accumulators); tts_single x2 through the
   narrow kernel against its plain ResBlocks with the same scales (SNR >
   40 dB); the float path's waves (equal lengths, SNR for information);
   calibrate_int8() after warmup(): the decoder graphs captured again in
   int8, the graphed tts_single = the eager one, stream() against it (0
   wide and 3 narrow launches a window, SNR > INT8_STREAM_SNR); then the
   server with a `quantize: int8` bf16 entry from a `states.ckpt`
   (/api/tts, /api/tts/stream = the model's stream()) and the inference
   CLI with --quantize int8 on the 16 prompts (within 1 LSB of the served
   model's tts())
15. int8, Tacotron2: Tacotron2Wave(quantize="int8") in f32, its decodes
   capped at T2_INT8_STEPS (1000; phase 12 runs 3000), the constructor's
   calibration decodes included; warmup() of the two batches' graphs;
   tts() of the 16 prompts (0 wide, 3 narrow launches per generator call;
   lengths = the float vocoder's run of the same decodes, SNR for
   information); the int8 generator against its plain ResBlocks (SNR >
   40 dB); stream() after calibration against tts_single(
   postprocess_mel=False) (SNR > INT8_T2_STREAM_SNR) and its first chunk's
   time
16. Vocos: FastPitch2Wave(vocoder_type="vocos") in bf16, CONFIG_22K (dim
   512, 8 ConvNeXt layers of 1536), seeded, after warmup(): three timed
   tts() of the 16 prompts (no ResBlock or MAS launch in the last), the
   real-time factor beside phase 4's HiFi-GAN one, one under
   torch.profiler; stream() of the first 4 prompts joined against
   tts_single (its seam error and SNR > STREAM_BF16_SNR); the f32 module on
   the card against the same weights on the CPU (within 1e-4 of the
   peak); MelVocos (seeded) and Vocos.from_hparams from a YAML file of
   nested mappings and a `.pth` (decode = the module within 1e-5;
   copy-synthesis)

17. adversarial FastPitch: a new copy of phase 6's corpus with a config
   from configs/nawar_fp_adv.yaml (gan 3.0, feat 1.0, betas (0, 0.99)
   for both optimizers), `apps.train_fastpitch.main --adv` at full width
   (FastPitchConfig() and PatchDiscriminator(32)), one epoch (6 steps of
   batch 10) and 1 validation batch, PyTorch's default precision, the
   launch counters set to 0 just before and read just after. Checks:
   finite loss, loss_d, score and fmatch at every step, MAS launches =
   steps + validation batches at phase 6's shapes, MAS bit-equal to
   `align.mas.mas` at those shapes and lengths (and its ms there), every
   generator and critic parameter and iteration vector moved, the
   checkpoint restores model, optim, model_d, optim_d and spectral_d
   equal. Prints steps/s over steps 2-6; then one steady step under
   torch.profiler (MAS's share of the device time, the idle share, the
   top ops) and the critic's work of a step replayed alone (CUDA events)
   against that step's device busy time; then one f32 step (TF32 off,
   dropouts off) on the card against the same step on the CPU from the
   same weights and chunks (two rows of the first batch): loss terms
   within STEP_LOSS_TOL relative, gradients within STEP_GRAD_TOL of their
   norm, the critic's vectors within 1e-6
18. Tacotron2 training: configs from nawar_tc2.yaml and nawar_tc2_adv.yaml
   (the basic.yaml overlay: batch 8, clip 1.0) on the same corpus,
   `apps.train_tacotron.main` at full width (Tacotron2Config()): 3 MSE
   steps with validation, then 3 `--adv` steps (PatchDiscriminator(32),
   gan 4.0, reading the postnet mel); no ResBlock or MAS launch. Checks:
   finite losses, every parameter and BatchNorm statistic moved (and the
   critic), the checkpoint restores model, optim, batch_stats (and
   model_d, optim_d, spectral_d) equal. Prints each run's steps/s over
   steps 2-3, one steady MSE step under torch.profiler (device busy,
   idle share, top ops), and one f32 `--adv` step on the card against the
   CPU (TF32 and every dropout off) at full width on the corpus's two
   shortest utterances cut to T2_SHORT_FRAMES frames, at phase 17's
   tolerances and BatchNorm statistics within 1e-5

19. HiFi-GAN vocoder training, in the same corpus: the f32 ResBlock
   kernels at the training shapes (segment 8192 = 32 frames, stage
   lengths 256/2048/4096/8192 at C 256/128/64/32, k 3/7/11, at each batch
   size of the run) against `resblock1_plain` (TF32 off) with their ms,
   the plain version's ms (cuDNN f32) and the bounds (3xTF32's and the
   CUDA cores'), and `ResBlock1Function`'s
   gradients against autograd of the plain version (GRAD_TOL of their
   norm); then `apps.train_vocoder.main` with configs/hifigan_ft.yaml's
   values (HiFi-GAN V1 warm-started from a seeded reference `.pth`, full
   MPD and MSD, segment 8192, batch 16), one epoch (4 steps) and 1
   validation batch, PyTorch's default precision, the launch counters set
   to 0 just before and read just after. Checks: ResBlock launches = 54
   wide + 6 narrow a step + 27 + 3 a validation batch, no MAS launch,
   finite terms, the warm start loaded, every generator and discriminator
   parameter moved, the checkpoint restores model, optim, model_d and
   optim_d equal. Prints steps/s over steps 2-4, one steady step under
   torch.profiler (the ResBlock kernels' share of the device time, the
   idle share, the top ops), and one step at full width on two rows of
   4096 samples in f32 on the card (TF32 off), in f32 on the CPU and in
   float64 on the CPU: loss terms within STEP_LOSS_TOL of both, the
   gradients (the discriminators' included) within STEP_GRAD_TOL of the
   float64 step's, or within F32_SPREAD times the CPU f32 step's own
   distance from it where that is larger

20. AOT serving bundles and the offline apps: phase 4's FastPitch +
   HiFi-GAN V1 (bf16, seeded) saved as a `states.ckpt` and exported with
   `apps.export_serving.export_bundle` at batch 8 and the text and mel
   buckets the 16 prompts take on the live path (the export's seconds, the
   `.pt2` bytes), served by `ServingBundle` against the live
   `tts(out_int16=True)` (within BUNDLE_LSB; 27 wide + 3 narrow launches
   per wave-program call, the ResBlock op inside the exported program),
   the bundle's and the live path's real-time factor (median of 3 by
   `runtime.profiling.benchmark`) and the MFU of one bundle serving
   (`eval.flops` over its profiled device busy time, against
   `chip_peak_flops` bf16); then phase 12's Tacotron2 in bf16, decodes
   capped at T2_BUNDLE_STEPS, exported with `export_bundle_tacotron` and
   served by `Tacotron2ServingBundle` against the live path (within
   BUNDLE_LSB, launches, time); the live path's two routes to the ResBlock
   kernel (the launch called directly, the custom op) by their host cost
   a call, phase 9's first-chunk share and phase 4's real-time factor in
   turns; then the offline apps on a fresh copy of phase 6's corpus:
   `preprocess` audio, text and f0 (against the corpus's true f0),
   `evaluate` on the 3 shortest test utterances (copy-synthesis: MCD and
   every aligned delta exactly 0; FastPitch and Tacotron2: finite; the
   Tacotron2 run's DTW calls on the port's native library timed, and one
   cosine DTW of 3000 x 200 frames native against numpy: equal paths),
   `export_torch` of phase 7's `states.ckpt` (the same tensors; its `.pth`
   serves the checkpoint's waves exactly), `smoke_test` of both models,
   and `download --verify` with a stub fetcher (one OK, one corrupt FAIL);
   each app's seconds and the phase's
21. gate-controlled Tacotron2: `Tacotron2Wave` in bf16 with
   `Tacotron2Config(num_speakers=64)` and HiFi-GAN V1 (the JAX bench's
   configuration), seeded, on the 16 prompts at decoder_max_step
   GATE_STEPS (768) and batch 16: the batch's decode-block graph
   captured, then `eval.gate_control.install_gate_control` with min_len
   GATE_MIN_LEN (86) from an empty cache under build/ (seconds, graph
   replays, targets, realized lengths, off target, fired, cap preferred
   and fallback, the gate scale, the channels and dithers) and a second
   install, which must replay the cache with the same speakers and
   lengths; tts(speaker_id=speakers, postprocess_mel=False,
   out_int16=True) with the counters set to 0 just before and read just
   after: every wave's frames = its calibrated length, at most
   GATE_MAX_FALLBACK utterances at the cap off target, at least 3
   distinct stops, 27 wide + 3 narrow launches a generator call, MAS 0;
   speakers 16-31 given speakers 0-15's embedding with the gate channel
   zeroed decode mels bit-equal over each controlled row's length (and to
   the cap); those controlled mels vocoded through the bf16 kernels and
   through the plain ResBlocks in f32 (SNR of each row, gated at
   SNR_GATE); every ResBlock kernel at the generator call's stage shapes
   ([16, 768 x samples a frame]) on seeded inputs, held against the plain
   version in f32 (TOL) and timed beside the plain version and its bound;
   three timed tts() (real-time factor beside phase 12's, frames
   a token) and one under torch.profiler (the ResBlocks' share of the
   device time, the idle share); the phase's seconds
22. the parallel layer (`tts_arabic_torch.parallel`): PAR_RANKS (2)
   spawned ranks that share cuda:0 over an explicit gloo backend (NCCL
   refuses two ranks on one GPU), joined through a FileStore in a temp
   dir under build/, on a fresh copy of phase 6's corpus: (a) 3 DP
   FastPitch MSE steps at full width, global batch 10, dropout off, f32
   TF32 off: before each step rank 0 gives a copy of its parameters the
   same step in one process (every step's loss terms within 1e-5
   relative, its gradients within 1e-5 of their norm), the same 3 steps
   from the initial weights in one process (the parameters after them
   within PAR_PARAM_TOL of their norm) and a planted fault, the 3 steps on
   rank 0's half of each batch alone (which must miss by more than
   PAR_PARAM_TOL); parameters equal on both ranks; each rank's MAS calls
   bit-equal to the plain MAS on the same soft attention, one MAS launch a
   rank a step and no ResBlock launch; steps/s of both; (b) one DP
   Tacotron2 MSE step at full width of 8 rows cut to 192 frames (terms,
   BatchNorm running statistics and gradients against one process); (c)
   `sp_vocode` of phase 9's joined mel (the first 13 prompts) through
   HiFi-GAN V1 in f32 and bf16, one frame shorter (ragged) and through
   Vocos (overlap 32) against the whole call on the card (f32 within 1e-5
   of the peak, bf16 SNR > SNR_GATE on every rank), each rank's own
   generator windows vocoded again with the ResBlocks on the plain version
   in f32 (SNR of every row > SNR_GATE), each rank's kernel launches (27
   wide + 3 narrow a window), one halo exchange timed; (d)
   `FastPitch2Wave(mesh=)` in bf16 on the 16 prompts at batch 8 against
   one process's tts() (equal lengths, f32 SNR > SNR_GATE, the int16
   waves within PAR_LSB), each rank's generator calls vocoded again with
   the plain ResBlocks in f32 (SNR of every row > SNR_GATE), each rank's
   launches, both rates; (e) `tp_mel_infer_jit` at full width on a 1 x 2
   (data x model) mesh against the one-device infer (rtol 2e-4, atol
   2e-5), its all-reduces a call
   (12); the phase's seconds

Then nvidia-smi's line again, the smoke's seconds, the kernels' JSON
record (for each ResBlock variant its ms, plain_ms and bound_ms summed
over the serving path's bf16 launches, as timed in phase 3; for MAS the
same sums over the training run's launches, as timed in phase 6;
`tacotron2_launches` and `int8_launches`, each kernel's launches in phase
12's and phase 14's counted tts(); for the ResBlocks `tacotron2_ms`,
`tacotron2_plain_ms`, `tacotron2_bound_ms` (3xTF32),
`tacotron2_cuda_core_ms` and `tacotron2_max_abs_err`, the f32 kernels
at phase 12's stage shapes; for MAS also `adversarial_launches`
and `adversarial_ms`, phase 17's launches and their summed kernel ms;
`vocoder_train_launches`, phase 19's, and for the ResBlocks
`vocoder_train_ms`, `vocoder_train_plain_ms`, `vocoder_train_bound_ms`
(3xTF32) and `vocoder_train_cuda_core_ms` summed over them as timed in
phase 19; `bundle_launches` and
`tacotron2_bundle_launches`, phase 20's launches while the FastPitch and
the Tacotron2 bundle served the 16 prompts; `tacotron2_gate_launches`,
phase 21's counted tts(), and for the ResBlocks `tacotron2_gate_ms`,
`tacotron2_gate_plain_ms`, `tacotron2_gate_bound_ms` and
`tacotron2_gate_max_abs_err` over its generator call's stage shapes, as
timed in phase 21; `sp_launches_per_rank`, `dp_serving_launches_per_rank`
and `dp_train_launches_per_rank`, each kernel's launches on each rank, as
counted around phase 22's bf16 `sp_vocode`, its counted DP tts() and its
DP training steps), and last
the result line. Any
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
import queue as queue_mod
import os
import re
import shutil
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
# the f32 ResBlock kernels run 3xTF32 on the tensor cores: three TF32
# products a term at the TF32 tensor rate (495 TFLOP/s dense) bound their
# operations at a third of it. PEAK_FLOPS[float32] stays the f32 CUDA
# cores' rate, which bounds the Tacotron2 decode's cuBLAS f32 GEMMs (TF32
# off); the ResBlock rows print it beside the new bound, as their CUDA-core
# bound (the rate of cuDNN's f32 convs, and of the first, CUDA-core
# design of these kernels)
RESBLOCK_F32_FLOPS = 495e12 / 3
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
# the serving slice (phases 9-11): stream() windows of STREAM_CHUNK frames
# plus STREAM_OVERLAP on each side
STREAM_CHUNK, STREAM_OVERLAP = 128, 16
STREAM_WINDOW = STREAM_CHUNK + 2 * STREAM_OVERLAP
# phase 9's long utterance: the first N prompts joined, N from this up to
# the first that makes STREAM_MIN_CHUNKS chunks (the random model's
# durations depend on the whole text: on the card the first 4 made 7
# chunks, the first 5 made 5)
N_STREAM_PROMPTS = 4
STREAM_MIN_CHUNKS = 8
STREAM_F32_TOL = 1e-4   # f32: max |stream - tts_single|
# bf16: SNR (dB) of stream against tts_single: the first reading on an
# H100 (39.56 dB) less 3
STREAM_BF16_SNR = 36.56
FIRST_CHUNK_SHARE = 0.75  # time to the first chunk / the whole tts_single
# the mixed requests of phases 9 and 11: request i runs at speed
# MIX_SPEEDS[i % 5] and pitch_mul MIX_PITCHES[i % 3] (the server's rate
# slider moves in steps of 0.05)
MIX_SPEEDS = (1.0, 0.85, 1.1, 0.95, 1.25)
MIX_PITCHES = (1.0, 1.1, 0.9)
DIAC_TOL = 1e-5         # phase 10: |batched - single| class probability
# the int8 and Vocos slice (phases 14-16): the int8 generator against its
# plain ResBlocks with the same scales (only the narrow stage differs),
# at phase 5's f32 gate
INT8_SNR_GATE = 40.0
# an int8 stream against its tts_single (SNR, dB), where a window's float
# ops may round some int8 grid ties apart from the whole call's: bf16
# FastPitch at the float bf16 stream's gate (read exact on an H100);
# f32 Tacotron2 at 40 (47-51 dB on the CPU tests, 125 dB on an H100)
INT8_STREAM_SNR = STREAM_BF16_SNR
INT8_T2_STREAM_SNR = 40.0
# phase 15 decodes this many steps (phase 12: 3000), the constructor's
# calibration decodes included
T2_INT8_STEPS = 1000
# phases 17-18: a step on the card against the same step on the CPU (f32,
# TF32 off): loss terms (relative), gradients (of their norm), as the CPU
# parity tests against JAX hold them
STEP_LOSS_TOL = 1e-5
STEP_GRAD_TOL = 1e-4
# phase 19: at full width an f32 vocoder step's gradients lie 1.8e-4 to
# 2.8e-4 of their norm from the float64 step's, on the CPU as on the card
# (an H100 beside its host's CPU; on the card as much with plain ResBlocks
# as with the kernels); the card's f32 step is held to the float64 one
# within this factor of the CPU f32 step's own distance
F32_SPREAD = 4.0
T2_STEPS = 3            # phase 18's steps of each recipe
T2_SHORT_FRAMES = 192   # phase 18's card-vs-CPU batch: mels cut to this
T_START = 0.0


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
            args = re.findall(r"Li(\d+)E", targs)
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
        elif re.search(r"registers|spill", ln):
            out.setdefault(name, []).append(
                ln.split(":", 1)[-1].strip() if "Used" in ln else ln.strip())
    return [f"{n}: {'; '.join(v)}" for n, v in out.items()]


def sass_mma(lib_path: str) -> dict | None:
    """Each ResBlock kernel's tensor-core instructions in the built
    library (`cuobjdump -sass`): {kernel: Counter of HMMA opcodes}; None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : \w*?\d+(resblock1\w*?kernel)(I\w*?E)?E",
                      ln)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            out[name] = collections.Counter()
        elif "Function :" in ln:
            name = None
        elif name and (op := re.search(r"\b(HMMA\.\S+)", ln)):
            out[name][op.group(1)] += 1
    return out


def phase_build() -> None:
    """Builds the kernels; prints ptxas's registers and spills per kernel
    and, from the library's SASS, each ResBlock kernel's tensor-core
    instructions: every f32 (tf32) kernel must run TF32 HMMA and every
    bf16 (mma) kernel BF16 HMMA."""
    from tts_arabic_torch.ops import build
    t0 = time.perf_counter()
    lib = build.library()
    took = time.perf_counter() - t0
    srcs = ", ".join(p.name for p in sorted(build.CSRC.glob("*.cu")))
    log(f"[2 build] {srcs} -> sm_90a in {took:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s, one process per source)")
    for ln in ptxas_lines(build.build_log):
        log(f"    ptxas: {ln}")
    mma = sass_mma(lib._name)
    if mma is None:
        log("    sass: no cuobjdump in the toolkit, not listed")
        return
    for name, ops in sorted(mma.items()):
        log(f"    sass: {name}: " + (", ".join(
            f"{op} x {n}" for op, n in sorted(ops.items())) or "no HMMA"))
        want = ("TF32" if "tf32_kernel" in name else
                "BF16" if "mma_kernel" in name else None)
        if want and not any(want in op for op in ops):
            raise AssertionError(f"{name}: no {want} HMMA in its SASS")


def _case(C: int, k: int, T: int, dtype, gen: torch.Generator,
          batch: int = BATCH):
    """Inputs on the card: x ~ N(0, 1), weights ~ N(0, 1/(k C)) (the
    lecun-normal scale of the random init), biases ~ N(0, 0.1)."""
    n = len(DILATIONS)
    rand = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=gen, device="cuda")
    x = rand(batch, T, C)
    w1, w2 = (rand(n, C, C, k) / (k * C) ** 0.5 for _ in range(2))
    b1, b2 = (0.1 * rand(n, C) for _ in range(2))
    return x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2


def bound(C: int, k: int, T: int, dtype,
          batch: int = BATCH) -> tuple[float, float]:
    """Least times (ms) for one ResBlock1 on [batch, T, C]: 6 convs of
    2 k C^2 FLOPs per row at the kernels' rate for the dtype (bf16 tensor
    cores; f32 3xTF32, RESBLOCK_F32_FLOPS), and x read once, y written
    once and the weights read once at the memory rate."""
    esize = torch.finfo(dtype).bits // 8
    flops = 12 * k * C * C * batch * T
    nbytes = 2 * batch * T * C * esize + 6 * k * C * C * esize + 6 * C * 4
    peak = (RESBLOCK_F32_FLOPS if dtype == torch.float32
            else PEAK_FLOPS[dtype])
    return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def cuda_core_ms(C: int, k: int, T: int, batch: int = BATCH) -> float:
    """One f32 ResBlock1's operations at the f32 CUDA cores' rate (ms): the
    bound of cuDNN's f32 convs and of the kernels' first, CUDA-core
    design, printed beside the 3xTF32 bound."""
    return 12 * k * C * C * batch * T / PEAK_FLOPS[torch.float32] * 1e3


def _rel_err(rb, name, C, k, T, dtype, gen, batch: int = BATCH):
    """Runs the kernel once on fresh inputs and holds it against the plain
    version in f32 on the same inputs; returns (inputs, abs err, rel
    err)."""
    x, w1, b1, w2, b2 = _case(C, k, T, dtype, gen, batch)
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


def phase_kernel_checks(calls: list[tuple[int, int]]) -> dict:
    """Every variant, width, kernel size and dtype at the rows and stage
    lengths of the main path's generator calls (`calls`: (rows, mel
    frames) each; a shape that recurs is timed once and counted for each
    call), and once at the first's rows and a length 3 rows short of its
    own, which no tile divides."""
    from tts_arabic_torch.ops import resblock as rb
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    set_tf32(False)     # f32 plain convs in full f32, not TF32
    log(f"[3 kernel checks] B, T = rows and stage length of the main "
        f"path's generator calls ({', '.join(f'{b} x {f}' for b, f in calls)}"
        " rows x frames), and of the first less 3 rows; err = max|kernel - "
        "plain| / max|plain|; "
        "f32: the 3xTF32 tensor-core kernels, bound_ms their operations at "
        f"{RESBLOCK_F32_FLOPS / 1e12:.0f} TFLOP/s (cc_ms: at the CUDA cores' "
        f"{PEAK_FLOPS[torch.float32] / 1e12:.0f}); bf16: the bf16 "
        "tensor-core kernels; share = bound_ms / ms")
    log(f"    {'variant':17} {'C':>4} {'k':>3} {'dtype':>5} {'B':>3} "
        f"{'T':>7} {'err':>9} {'tol':>7} {'ms':>9} {'plain_ms':>9} "
        f"{'bound_ms':>9} {'cc_ms':>9} {'share':>6}")
    variants = ([("resblock1_wide", C) for C in WIDE_CHANNELS]
                + [("resblock1_narrow", C) for C in NARROW_CHANNELS])
    for name, C in variants:
        for k in KERNEL_SIZES:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")[:5]
                B, T = calls[0][0], STAGE_T[C] * calls[0][1] - 3
                _, _, rel = _rel_err(rb, name, C, k, T, dtype, gen, B)
                log(f"    {name:17} {C:>4} {k:>3} {dname:>5} {B:>3} {T:>7} "
                    f"{rel:>9.2e} {TOL[dtype]:>7.0e}")
                for (B, f), n_calls in collections.Counter(calls).items():
                    T = STAGE_T[C] * f
                    args, err, rel = _rel_err(rb, name, C, k, T, dtype, gen,
                                              B)
                    ms = cuda_ms(lambda: _launch(rb, name, *args, k))
                    plain_ms = cuda_ms(lambda: rb.resblock1_plain(
                        *args, k, DILATIONS))
                    t_ops, t_bytes = bound(C, k, T, dtype, B)
                    b_ms = max(t_ops, t_bytes)
                    cc = (f"{cuda_core_ms(C, k, T, B):>9.3f}"
                          if dtype == torch.float32 else f"{'-':>9}")
                    log(f"    {name:17} {C:>4} {k:>3} {dname:>5} {B:>3} "
                        f"{T:>7} {rel:>9.2e} {TOL[dtype]:>7.0e} {ms:>9.3f} "
                        f"{plain_ms:>9.3f} {b_ms:>9.3f} {cc} "
                        f"{100 * b_ms / ms:>5.1f}%")
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


def make_pipe(compute_dtype, arabic_in: bool = False):
    from tts_arabic_torch.infer import FastPitch2Wave
    pipe = FastPitch2Wave(seed=0, arabic_in=arabic_in,
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

    def counted(self, mel, **kw):
        calls.append(tuple(mel.shape))
        return forward(self, mel, **kw)

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
                    kernel_ms: float, smi: str) -> tuple[dict, float]:
    """N_TIMED tts() calls of the prompts, each timed on the host clock:
    the first ones re-warm the allocator (phase 3 emptied its cache), the
    last is the main path's run, with the launch counters set to 0 just
    before it and read just after. -> (its launches, its real-time
    factor)."""
    from tts_arabic_torch.infer.pipeline import _pick_mel_bucket
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder.hifigan import length_groups
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
    # tts()'s batches (the global sort by characters), each vocoded in the
    # length groups of its rows' frames
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    lens = [mels[i].shape[1] for i in order]
    groups = [length_groups(b, _pick_mel_bucket(max(b)))
              for b in (lens[k: k + BATCH]
                        for k in range(0, len(lens), BATCH))]
    want = sorted((len(rows), f) for g in groups for rows, f in g)
    if sorted(c[:2] for c in calls) != want or calls != shapes:
        raise AssertionError(f"generator calls {calls}, expected {want} (the "
                             f"length groups of each batch) as in the warm "
                             f"run's {shapes}")
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
    return launches, audio_s / wall


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
    return corpus_config(root, "nawar_fp.yaml")


def corpus_config(root: pathlib.Path, recipe: str, **over) -> pathlib.Path:
    """configs/<recipe> with the corpus's paths, logs and checkpoints in
    their own directories under `root`, and `over`; returns its path."""
    from tts_arabic_torch.runtime.config import load_yaml
    stem = recipe.removesuffix(".yaml")
    wavs = root / "wavs"
    cfg = load_yaml(ROOT / "configs" / recipe)
    cfg.update(log_dir=str(root / f"logs_{stem}"),
               checkpoint_dir=str(root / f"ckpt_{stem}"),
               train_wavs_path=str(wavs), train_labels=str(root / "train.txt"),
               test_wavs_path=str(wavs), test_labels=str(root / "test.txt"),
               f0_dict_path=str(root / "pitch_dict.npz"))
    cfg.update(over)
    path = root / f"{stem}_smoke.yaml"
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
    times, metas, mas_shapes = [], [], []
    fused = mas_ops.mas_fused

    def recorded(log_attn, in_lens, out_lens):
        mas_shapes.append(tuple(log_attn.shape))
        return fused(log_attn, in_lens, out_lens)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_fastpitch, "make_fastpitch_train_step",
                           timed_steps(steps.make_fastpitch_train_step,
                                       times, metas, [])), \
            mock.patch.object(mas_ops, "mas_fused", recorded):
        rb.reset_launches()
        mas_ops.reset_launches()
        trainer = train_fastpitch.main([
            "--config", str(config_path), "--epochs", "1", "--log-every",
            "1", "--device", "cuda", "--no-figures"])
        torch.cuda.synchronize()
        launches = {**rb.LAUNCHES, **mas_ops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_steps = len(train)
    for i, (m, t) in enumerate(zip(metas, times)):
        log(f"    step {i + 1}: loss {m['loss']:.4f}, {t * 1e3:.1f} ms")
    if len(times) != n_steps or trainer.state.step != n_steps:
        raise AssertionError(f"{len(times)} steps timed, state at step "
                             f"{trainer.state.step}, expected {n_steps}")
    _finite(metas, ("loss",))
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


# ---- the serving slice: stream(), vowelizers, server and CLI -----------------

def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    ref, got = ref.astype(np.float64), got.astype(np.float64)
    return float(10 * np.log10(np.mean(ref ** 2)
                               / (np.mean((ref - got) ** 2) + 1e-30)))


def phase_stream_kernels() -> dict:
    """The bf16 kernels at one streamed window's shapes (B = 1,
    STREAM_WINDOW frames at each stage's samples per frame), against the
    plain version in f32, with the kernel's ms, the plain version's ms (in
    bf16) and the bound; returns each variant's sums over one chunk's
    launches."""
    from tts_arabic_torch.ops import resblock as rb
    gen = torch.Generator(device="cuda").manual_seed(9)
    set_tf32(False)
    dtype = torch.bfloat16
    log(f"[9 stream kernels] bf16, B=1, T = {STREAM_WINDOW} frames x the "
        "stage's samples per frame; err = max|kernel - plain| / max|plain|")
    log(f"    {'variant':17} {'C':>4} {'k':>3} {'T':>7} {'err':>9} "
        f"{'tol':>7} {'ms':>9} {'plain_ms':>9} {'bound_ms':>9}")
    per_chunk = {}
    for C in WIDE_CHANNELS + (32,):
        name = rb.variant(C)
        T = STREAM_WINDOW * STAGE_T[C]
        for k in KERNEL_SIZES:
            args, err, rel = _rel_err(rb, name, C, k, T, dtype, gen, batch=1)
            ms = cuda_ms(lambda: rb.resblock1(*args, k, DILATIONS))
            plain_ms = cuda_ms(lambda: rb.resblock1_plain(*args, k,
                                                          DILATIONS))
            t_ops, t_bytes = bound(C, k, T, dtype, batch=1)
            log(f"    {name:17} {C:>4} {k:>3} {T:>7} {rel:>9.2e} "
                f"{TOL[dtype]:>7.0e} {ms:>9.4f} {plain_ms:>9.4f} "
                f"{max(t_ops, t_bytes):>9.4f}")
            s = per_chunk.setdefault(name, dict(ms=0.0, plain_ms=0.0,
                                                bound_ms=0.0))
            s["ms"] += ms
            s["plain_ms"] += plain_ms
            s["bound_ms"] += max(t_ops, t_bytes)
            del args
    for name, s in per_chunk.items():
        log(f"    one chunk, {name}: {s['ms']:.4f} ms (plain "
            f"{s['plain_ms']:.4f}, bound {s['bound_ms']:.4f} = "
            f"{100 * s['bound_ms'] / s['ms']:.1f}% of the kernel's time)")
    torch.cuda.empty_cache()
    return per_chunk


def weight_prep_ms(pipe, reps: int = 20) -> float:
    """Host ms of the per-call weight preparation of one window's
    ResBlocks, as `ResBlock1.forward` and `ops.resblock.resblock1` do it
    (the stacks and their kernel layout, kept between calls, looked up;
    the bias casts), ending in a synchronize; the mean of `reps`."""
    from tts_arabic_torch.ops import resblock as rb
    dtype = pipe.compute_dtype or torch.float32

    def prep():
        for blk in pipe.vocoder.resblocks:
            w1, b1, w2, b2 = blk._stacks()
            for w, b in ((w1, b1), (w2, b2)):
                rb.kernel_weights(w, dtype)
                b.contiguous().to(torch.float32)

    with torch.no_grad():
        prep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            prep()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _checked_resblock(records: list):
    """`resblock1` through the kernel, each call also held against the
    plain version in f32 on the same input; records (C, T, x 16-byte
    aligned, rel err)."""
    from tts_arabic_torch.ops import resblock as rb

    def run(x, w1, b1, w2, b2, k, dilations):
        out = rb.resblock1(x, w1, b1, w2, b2, k, dilations)
        w1f, w2f = (w.to(x.dtype).float() for w in (w1, w2))
        ref = rb.resblock1_plain(x.float(), w1f, b1.float(), w2f, b2.float(),
                                 k, dilations)
        err = float((out.float() - ref).abs().max() / ref.abs().max())
        records.append((x.shape[-1], x.shape[1], x.data_ptr() % 16 == 0,
                        err))
        return out

    return run


def capture(pipe) -> tuple[float, float]:
    """pipe's one-row encode and decoder graphs captured in its decode
    dtype: (wall seconds, MiB of device memory they hold)."""
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    pipe.model.capture_graphs(pipe.compute_dtype)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0,
            (torch.cuda.memory_reserved() - reserved) / 2 ** 20)


def eager(pipe):
    """pipe's CUDA graphs set aside while the block runs: its one-row
    encodes and decodes run eagerly."""
    return mock.patch.dict(pipe.model._graphs, clear=True)


def first_and_whole(pipe, text: str, kw: dict,
                    fresh_words: bool = False) -> tuple[list, list]:
    """3 runs each, host clock: seconds to the first chunk of
    stream(text) (the rest drained after the clock stops) and of the whole
    tts_single(text); with `fresh_words`, the tokenizer's word cache is
    emptied before each call."""
    from tts_arabic_torch.text import phonetizer
    firsts, fulls = [], []
    for _ in range(3):
        if fresh_words:
            phonetizer.clear_word_cache()
        t0 = time.perf_counter()
        gen = pipe.stream(text, **kw)
        next(gen)
        firsts.append(time.perf_counter() - t0)
        for _ in gen:
            pass
        if fresh_words:
            phonetizer.clear_word_cache()
        t0 = time.perf_counter()
        pipe.tts_single(text, denoise=kw["denoise"])
        fulls.append(time.perf_counter() - t0)
    return firsts, fulls


def mixed_requests(pipe, prompts: list[str], kw: dict) -> dict:
    """One request for each prompt, at the MIX_SPEEDS and MIX_PITCHES in
    turn: the seconds to its stream's first chunk and to its whole
    tts_single, both replaying the graphs, each with the tokenizer's word
    cache emptied first (its text's words met nowhere before); each stream
    must hold the eager tts_single of its text and rate at
    STREAM_BF16_SNR."""
    from tts_arabic_torch.infer import pipeline as pl
    from tts_arabic_torch.text import phonetizer
    out = dict(first=[], whole=[], snr=[], buckets=[], chunks=0, audio_s=0.0)
    for i, text in enumerate(prompts):
        rate = dict(speed=MIX_SPEEDS[i % len(MIX_SPEEDS)],
                    pitch_mul=MIX_PITCHES[i % len(MIX_PITCHES)])
        replays = pipe.model.graph_replays
        phonetizer.clear_word_cache()
        t0 = time.perf_counter()
        gen = pipe.stream(text, **rate, **kw)
        chunks = [next(gen)]
        out["first"].append(time.perf_counter() - t0)
        chunks += list(gen)
        phonetizer.clear_word_cache()
        t0 = time.perf_counter()
        pipe.tts_single(text, denoise=kw["denoise"], **rate)
        out["whole"].append(time.perf_counter() - t0)
        if pipe.model.graph_replays - replays < 4:
            raise AssertionError(f"request {i} replayed "
                                 f"{pipe.model.graph_replays - replays} "
                                 "graphs")
        with eager(pipe):
            want = pipe.tts_single(text, denoise=kw["denoise"], **rate)
        got = np.concatenate(chunks)
        if got.shape != want.shape:
            raise AssertionError(f"request {i}: stream {got.shape} vs "
                                 f"eager tts_single {want.shape}")
        out["snr"].append(snr_db(want, got))
        out["buckets"].append(pl._pick_mel_bucket(len(want)
                                                  // pipe.hop_length))
        out["chunks"] += len(chunks)
        out["audio_s"] += len(got) / pipe.sample_rate
    if not min(out["snr"]) > STREAM_BF16_SNR:
        raise AssertionError(f"mixed requests: SNR {out['snr']}")
    return out


def phase_stream(smi: str) -> dict:
    """stream() of the first prompts joined (N_STREAM_PROMPTS or more), at
    full width in bf16 (phase 4's configuration) with the one-row graphs
    captured, against tts_single: lengths, SNR against the graphed and the
    eager tts_single, launches per chunk (the counters set to 0 just before
    the counted stream and read just after), every launch and the clamped
    last window against the plain version, the speculation fallback, int16
    and mu-law chunks, the weight preparation's host cost, time to the
    first chunk against the whole tts_single (graphs on both sides, then
    eager on both), the mixed requests, tts_long; then in f32."""
    from tts_arabic_torch.audio import mulaw_encode
    from tts_arabic_torch.infer import longform
    from tts_arabic_torch.infer import pipeline as pl
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    prompts = load_prompts(N_PROMPTS)
    kw = dict(chunk_frames=STREAM_CHUNK, overlap=STREAM_OVERLAP,
              denoise=0.005)
    pipe = make_pipe(torch.bfloat16)
    capture_s, graph_mib = capture(pipe)
    hop = pipe.hop_length
    for n_joined in range(N_STREAM_PROMPTS, len(prompts) + 1):
        text = " ".join(prompts[:n_joined])
        frames = pipe.model.ttmel(text).shape[1]
        if frames > (STREAM_MIN_CHUNKS - 1) * STREAM_CHUNK:
            break
    else:
        raise AssertionError(f"no run of the prompts makes "
                             f"{STREAM_MIN_CHUNKS} chunks")
    full = pipe.tts_single(text, denoise=0.005)
    with eager(pipe):
        full_eager = pipe.tts_single(text, denoise=0.005)
    list(pipe.stream(text, **kw))               # warm
    torch.cuda.synchronize()
    replays = pipe.model.graph_replays
    rb.reset_launches()
    chunks = list(pipe.stream(text, **kw))
    launches = dict(rb.LAUNCHES)
    replayed = pipe.model.graph_replays - replays
    n = len(chunks)
    streamed = np.concatenate(chunks)
    if n < STREAM_MIN_CHUNKS or any(len(c) != STREAM_CHUNK * hop
                                    for c in chunks[:-1]):
        raise AssertionError(f"{n} chunks of {[len(c) for c in chunks]}")
    if streamed.shape != full.shape or not np.isfinite(streamed).all():
        raise AssertionError(f"stream {streamed.shape} vs tts_single "
                             f"{full.shape}")
    # a first window vocoded from the speculative mel is thrown away when
    # the utterance outruns its bucket, and vocoded again
    spec_bucket = pl._pick_mel_bucket(max(STREAM_WINDOW,
                                          pl.STREAM_SPEC_FRAMES))
    speculated = len(full) // hop + STREAM_WINDOW <= spec_bucket
    windows = n + (0 if speculated else 1)
    per_window = {k: v / windows for k, v in launches.items()}
    if per_window != {"resblock1_wide": 27, "resblock1_narrow": 3}:
        raise AssertionError(f"launches {launches} over {windows} windows")
    if replayed != (2 if speculated else 3):
        raise AssertionError(f"the stream replayed {replayed} graphs")
    snr = snr_db(full, streamed)
    snr_eager = (snr_db(full_eager, streamed)
                 if full_eager.shape == full.shape else -math.inf)

    records = []
    with mock.patch.object(hifigan, "resblock1", _checked_resblock(records)):
        list(pipe.stream(text, **kw))
        n_stream_calls = len(records)
        m = pipe.model
        enc, _, _ = m._encode_batch([m.tokenize(text)], 0, 1.0, 0.0, None,
                                    1.0)
        bucket = pl._pick_mel_bucket(max(int(enc["dec_len_max"]),
                                         STREAM_WINDOW))
        with pl._exact_f32():
            mel, _ = m._decode_fn(enc["enc_out"].to(torch.bfloat16),
                                  enc["dur_pred"], 1.0, max_frames=bucket)
            pipe._stream_chunk_fn(mel, bucket - STREAM_WINDOW, 0.005,
                                  window=STREAM_WINDOW, use_denoiser=True,
                                  out_int16=False)
    worst = max(r[3] for r in records)
    if worst > TOL[torch.bfloat16] or not all(r[2] for r in records):
        raise AssertionError(f"stream ResBlock calls: worst err {worst}, "
                             f"aligned {[r[2] for r in records]}")

    with mock.patch.object(pl, "STREAM_SPEC_FRAMES", 1):
        fallback = np.concatenate(list(pipe.stream(text, **kw)))
    snr_fallback = snr_db(full, fallback) if fallback.shape == full.shape \
        else -math.inf
    for name, value in (("stream", snr), ("fallback", snr_fallback),
                        ("stream vs eager", snr_eager)):
        if not value > STREAM_BF16_SNR:
            raise AssertionError(f"bf16 {name} vs tts_single: SNR {value:.2f}"
                                 f" dB <= {STREAM_BF16_SNR}")

    s16 = list(pipe.stream(text, out_int16=True, **kw))
    mu = list(pipe.stream(text, out_int16="mulaw", **kw))
    if not (all(c.dtype == np.int16 for c in s16)
            and all(c.dtype == np.uint8 for c in mu)):
        raise AssertionError("int16 / mu-law chunk dtypes")
    want16 = (np.clip(streamed, -1.0, 1.0) * 32767.0).astype(np.int32)
    want_mu = mulaw_encode(torch.from_numpy(streamed)).numpy().astype(
        np.int32)
    d16 = int(np.abs(np.concatenate(s16).astype(np.int32) - want16).max())
    dmu = int(np.abs(np.concatenate(mu).astype(np.int32) - want_mu).max())
    if d16 > 1 or dmu > 1:
        raise AssertionError(f"int16 off by {d16} LSB, mu-law by {dmu}")

    prep_ms = weight_prep_ms(pipe)
    firsts, fulls = first_and_whole(pipe, text, kw)
    fresh_firsts, fresh_fulls = first_and_whole(pipe, text, kw,
                                                fresh_words=True)
    with eager(pipe):
        eager_firsts, eager_fulls = first_and_whole(pipe, text, kw)
    first_s, full_s = min(firsts), min(fulls)
    mix = mixed_requests(pipe, prompts, kw)

    paragraph = "".join(p + ("؟ " if i % 2 else ". ")
                        for i, p in enumerate(prompts))
    sentences = longform.split_sentences(paragraph)
    if sentences != [p.strip() for p in prompts]:
        raise AssertionError(f"split_sentences gave {len(sentences)}")
    long_wave = longform.tts_long(pipe, paragraph, denoise=0.005)
    waves = pipe.tts(sentences, batch_size=16, denoise=0.005)
    pause = int(round(0.25 * pipe.sample_rate))
    want_len = sum(len(w) for w in waves) + pause * (len(waves) - 1)
    if len(long_wave) != want_len or not np.isfinite(long_wave).all():
        raise AssertionError(f"tts_long {len(long_wave)} samples, "
                             f"expected {want_len}")
    log(f"[9 stream] bf16 stream() of the first {n_joined} prompts joined "
        f"({frames} frames): {n} chunks of {STREAM_CHUNK} frames (window "
        f"{STREAM_WINDOW}), {len(full)} samples = tts_single's, the first "
        f"window from the speculative mel: {speculated} | SNR vs tts_single "
        f"{snr:.2f} dB, speculation fallback {snr_fallback:.2f} dB (gate > "
        f"{STREAM_BF16_SNR}) | launches {launches} = {per_window} per "
        f"vocoded window | every ResBlock call of a stream "
        f"({n_stream_calls}) and of the clamped last window (start "
        f"{bucket - STREAM_WINDOW} of bucket {bucket}) vs plain: worst err "
        f"{worst:.2e} (tol {TOL[torch.bfloat16]:.0e}), x 16-byte aligned in "
        f"all {len(records)} | int16 within {d16} LSB, mu-law within {dmu} "
        f"code of the float chunks | weight preparation {prep_ms:.3f} ms "
        f"host a chunk | {smi}")
    log(f"[9 stream graphs] capture_graphs(): {capture_s:.3f} s, "
        f"{len(pipe.model._graphs)} graphs holding {graph_mib:.1f} MiB of "
        f"device memory | the stream replayed {replayed} | the stream "
        f"against the eager tts_single: SNR {snr_eager:.2f} dB | {smi}")
    log(f"[9 stream latency] host clock, 3 runs, one-row encode and decode "
        f"replayed from graphs on both sides: first chunk min "
        f"{first_s * 1e3:.2f} ms, median {np.median(firsts) * 1e3:.2f} ms | "
        f"whole tts_single min {full_s * 1e3:.2f} ms, median "
        f"{np.median(fulls) * 1e3:.2f} ms | first / whole "
        f"{first_s / full_s:.3f} (< {FIRST_CHUNK_SHARE}) | the same with "
        f"the word cache emptied before each call: first chunk min "
        f"{min(fresh_firsts) * 1e3:.2f} ms, whole min "
        f"{min(fresh_fulls) * 1e3:.2f} ms, first / whole "
        f"{min(fresh_firsts) / min(fresh_fulls):.3f} | eager on both "
        f"sides: first chunk min {min(eager_firsts) * 1e3:.2f} ms, median "
        f"{np.median(eager_firsts) * 1e3:.2f} ms, whole min "
        f"{min(eager_fulls) * 1e3:.2f} ms, median "
        f"{np.median(eager_fulls) * 1e3:.2f} ms, first / whole "
        f"{min(eager_firsts) / min(eager_fulls):.3f} | audio "
        f"{len(full) / pipe.sample_rate:.2f} s | tts_long of the "
        f"{len(prompts)} prompts: {len(long_wave)} samples = the sentences' "
        f"{sum(len(w) for w in waves)} + {len(waves) - 1} pauses of {pause} "
        f"| {smi}")
    log(f"[9 stream mix] {len(prompts)} requests, one per prompt, each a "
        f"text first met here (the word cache emptied before each call), "
        f"speeds {MIX_SPEEDS} and pitch_mul "
        f"{MIX_PITCHES} in turn, graphs: first chunk min "
        f"{min(mix['first']) * 1e3:.2f} ms, median "
        f"{np.median(mix['first']) * 1e3:.2f} ms, max "
        f"{max(mix['first']) * 1e3:.2f} ms | whole tts_single min "
        f"{min(mix['whole']) * 1e3:.2f} ms, median "
        f"{np.median(mix['whole']) * 1e3:.2f} ms, max "
        f"{max(mix['whole']) * 1e3:.2f} ms; by request, ms (mel bucket): "
        + ", ".join(f"{w * 1e3:.1f} ({b})"
                    for w, b in zip(mix["whole"], mix["buckets"]))
        + f" | {mix['chunks']} chunks, "
        f"{mix['audio_s']:.2f} s of audio | each stream against its eager "
        f"tts_single: worst SNR {min(mix['snr']):.2f} dB | {smi}")
    if not first_s < FIRST_CHUNK_SHARE * full_s:
        raise AssertionError(f"first chunk {first_s * 1e3:.1f} ms >= "
                             f"{FIRST_CHUNK_SHARE} x tts_single "
                             f"{full_s * 1e3:.1f} ms")
    del pipe, mel, enc
    torch.cuda.empty_cache()

    pipe = make_pipe(None)
    with eager(pipe):
        full_eager = pipe.tts_single(text, denoise=0.005)
    capture(pipe)
    full = pipe.tts_single(text, denoise=0.005)
    if full.shape != full_eager.shape:
        raise AssertionError(f"f32 graphs {full.shape} vs eager "
                             f"{full_eager.shape}")
    errs = [float(np.abs(full - full_eager).max())]
    for spec in (pl.STREAM_SPEC_FRAMES, 1):
        with mock.patch.object(pl, "STREAM_SPEC_FRAMES", spec):
            got = np.concatenate(list(pipe.stream(text, **kw)))
        if got.shape != full.shape:
            raise AssertionError(f"f32 stream {got.shape} vs {full.shape}")
        errs.append(float(np.abs(got - full).max()))
    log(f"[9 stream f32] max|stream - tts_single| {errs[1]:.2e}, with the "
        f"speculation fallback {errs[2]:.2e}, graphed tts_single against "
        f"the eager {errs[0]:.2e} (tol {STREAM_F32_TOL:.0e}) | {smi}")
    if max(errs) > STREAM_F32_TOL:
        raise AssertionError(f"f32 stream differs by {max(errs)}")
    del pipe
    torch.cuda.empty_cache()
    return dict(launches=launches, chunks=n)


def arabic_lines(n: int) -> list[str]:
    """The first n sentences of data/test_arab.txt, diacritics stripped."""
    harakat = set("ًٌٍَُِّْ")
    out = []
    for line in (ROOT / "data" / "test_arab.txt").read_text(
            encoding="utf-8").splitlines()[:n]:
        out.append("".join(ch for ch in line.split('"')[3]
                           if ch not in harakat))
    return out


def phase_vowelizers(smi: str) -> None:
    """Seeded Shakkala and Shakkelha on the card: predict(list) of 16
    lines against each line alone (equal strings, |dprob| <= DIAC_TOL),
    then tts() of the lines with vowelizer="shakkelha"."""
    from tts_arabic_torch.diacritizers import Shakkala, Shakkelha
    lines = arabic_lines(N_PROMPTS)
    for cls in (Shakkala, Shakkelha):
        model = cls(seed=0, device="cuda")
        model.predict(lines)                    # warm
        t0 = time.perf_counter()
        batch, probs = model.predict(lines, return_probs=True)
        batch_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        single = [model.predict(t, return_probs=True) for t in lines]
        single_ms = (time.perf_counter() - t0) * 1e3
        dprob = max(float(np.abs(p - q).max())
                    for p, (_, q) in zip(probs, single))
        same = sum(b == s for b, (s, _) in zip(batch, single))
        log(f"[10 vowelizer] {cls.__name__} seeded on the card: predict of "
            f"{len(lines)} lines batched {batch_ms:.1f} ms, one by one "
            f"{single_ms:.1f} ms | strings equal {same}/{len(lines)}, max "
            f"|dprob| {dprob:.2e} (tol {DIAC_TOL:.0e}) | {smi}")
        if same != len(lines) or not dprob <= DIAC_TOL:
            raise AssertionError(f"{cls.__name__}: batched differs from "
                                 "single")
        del model
    pipe = make_pipe(torch.bfloat16, arabic_in=True)
    kw = dict(vowelizer="shakkelha", batch_size=BATCH, denoise=0.005)
    pipe.tts(lines, **kw)                       # warm
    vowelizer = pipe.model._vowelizers["shakkelha"]
    predict = vowelizer.predict
    spent = []

    def timed_predict(text, *a, **k):
        t0 = time.perf_counter()
        out = predict(text, *a, **k)
        spent.append(time.perf_counter() - t0)
        return out

    with mock.patch.object(vowelizer, "predict", timed_predict):
        t0 = time.perf_counter()
        waves = pipe.tts(lines, **kw)
        wall = time.perf_counter() - t0
    mels = pipe.model.ttmel(lines, batch_size=BATCH, vowelizer="shakkelha")
    for w, m in zip(waves, mels):
        if w.size != m.shape[1] * pipe.hop_length or not np.isfinite(w).all():
            raise AssertionError("vowelized tts(): wave length or values")
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    log(f"[10 vowelized tts] tts() of the {len(lines)} lines, "
        f"vowelizer='shakkelha', bf16, batch {BATCH}: {audio_s:.2f} s of "
        f"audio in {wall * 1e3:.1f} ms, of which predict "
        f"{sum(spent) * 1e3:.1f} ms in {len(spent)} calls | {smi}")
    del pipe
    torch.cuda.empty_cache()


def _post(port: int, path: str, body: dict):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def phase_apps(smi: str, tmp: pathlib.Path) -> None:
    """The port's server on 127.0.0.1 (a free port, a thread) with a
    one-entry full-width bf16 registry, after its warmup(): /api/tts writes
    a wav; /api/tts/stream of each of the 16 prompts at the MIX_SPEEDS in
    turn, each s16le body equal to the model's own stream() of that text
    and rate, with its time to the first byte; then the inference CLI on
    the 16 prompts, against the same model's tts()."""
    import threading
    from http.server import ThreadingHTTPServer

    from scipy.io import wavfile

    from tts_arabic_torch.apps import inference, server
    prompts = load_prompts(N_PROMPTS)
    manager = server.TTSManager([{"name": "fastpitch-bf16",
                                  "type": "fastpitch",
                                  "compute_dtype": "bfloat16"}],
                                device="cuda")
    _, model = manager.models[0]
    with torch.no_grad():
        model.model.model.duration_predictor.fc.bias.add_(2.0)
    warm_s = manager.warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(manager))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    text = prompts[0]
    body = {"buckw": text, "rate": 1.0, "denoise": 0.005}
    try:
        conn, resp = _post(port, "/api/tts", body)
        waves = json.loads(resp.read())["waves"]
        conn.close()
        wav = server._STATIC / pathlib.Path(waves[0]["url"]).name
        if resp.status != 200 or wav.read_bytes()[:4] != b"RIFF":
            raise AssertionError(f"/api/tts: {resp.status}, {waves}")
        ttfb, n_bytes, spans = [], 0, []
        stream = manager.stream

        def timed_stream(*a, **k):
            """manager.stream, stamping when the handler calls it and when
            its first chunk is ready."""
            called = time.perf_counter()
            name, sr, gen = stream(*a, **k)

            def stamped():
                first = next(gen, b"")
                spans.append((called, time.perf_counter()))
                yield first
                yield from gen
            return name, sr, stamped()

        with mock.patch.object(manager, "stream", timed_stream):
            for i, text in enumerate(prompts):
                rate = MIX_SPEEDS[i % len(MIX_SPEEDS)]
                t0 = time.perf_counter()
                conn, resp = _post(port, "/api/tts/stream",
                                   {"buckw": text, "rate": rate,
                                    "denoise": 0.005})
                first = resp.read(2)
                ttfb.append(time.perf_counter() - t0)
                got = first + resp.read()
                conn.close()
                spans[-1] = (spans[-1][0] - t0, spans[-1][1] - spans[-1][0],
                             t0 + ttfb[-1] - spans[-1][1])
                want = b"".join(np.asarray(c).tobytes()
                                for c in model.stream(text, speed=rate,
                                                      denoise=0.005,
                                                      out_int16=True))
                if resp.status != 200 or got != want:
                    raise AssertionError(f"/api/tts/stream of prompt {i}: "
                                         f"{resp.status}, {len(got)} bytes vs "
                                         f"{len(want)}")
                n_bytes += len(got)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    log(f"[11 server] 127.0.0.1:{port}, registry of one full-width bf16 "
        f"FastPitch: warmup() {warm_s:.2f} s | /api/tts wrote {wav.name} "
        f"({wav.stat().st_size} bytes) | /api/tts/stream of the "
        f"{len(prompts)} prompts at speeds {MIX_SPEEDS} in turn: s16le "
        f"{n_bytes} bytes = the model's stream() of each | time to the "
        f"first byte min {min(ttfb) * 1e3:.2f} ms, median "
        f"{np.median(ttfb) * 1e3:.2f} ms, max {max(ttfb) * 1e3:.2f} ms; of "
        f"it, medians: request to the handler's call "
        f"{np.median([s[0] for s in spans]) * 1e3:.2f} ms, the first chunk "
        f"{np.median([s[1] for s in spans]) * 1e3:.2f} ms, headers and "
        f"chunk to the client {np.median([s[2] for s in spans]) * 1e3:.2f}"
        f" ms | {smi}")

    ckpt = save_checkpoint(model, tmp)
    lst = tmp / "prompts.txt"
    lst.write_text("\n".join(prompts) + "\n", encoding="utf-8")
    out_dir = tmp / "samples"
    t0 = time.perf_counter()
    inference.main(["--list", str(lst), "--buckwalter", "--checkpoint",
                    str(ckpt), "--out-dir", str(out_dir), "--batch-size",
                    str(BATCH)])
    cli_s = time.perf_counter() - t0
    want = model.tts(prompts, batch_size=BATCH, denoise=0.005)
    worst = 0
    for i, w in enumerate(want):
        _, got = wavfile.read(out_dir / f"wave_{i:04d}.wav")
        w16 = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
        if got.shape != w16.shape:
            raise AssertionError(f"CLI wave {i}: {got.shape} vs {w16.shape}")
        worst = max(worst, int(np.abs(got.astype(np.int32) - w16).max()))
    if worst > 1 or not (out_dir / "index.html").is_file():
        raise AssertionError(f"CLI waves off by {worst} LSB")
    log(f"[11 inference CLI] {len(prompts)} prompts from a states.ckpt, "
        f"bf16, batch {BATCH}, into {out_dir.relative_to(ROOT)}: "
        f"{cli_s:.2f} s wall (model load included) | wavs within {worst} "
        f"LSB of the served model's tts() | {smi}")
    del manager, model
    torch.cuda.empty_cache()


# ---- the Tacotron2 slice -----------------------------------------------------

def t2_pipe(**kw):
    """Full-width Tacotron2 (Tacotron2Config()) and HiFi-GAN V1, seeded
    random weights from seed 0, f32 decode and vocoder (the JAX CLI's
    Tacotron2), on the card."""
    from tts_arabic_torch.infer import Tacotron2Wave
    return Tacotron2Wave(seed=0, arabic_in=False, device="cuda", **kw)


def t2_batches(pipe, prompts: list[str]) -> list[tuple]:
    """tts()'s batches of the prompts (the global length sort, then
    BATCH rows each): (padded ids, sorted token lens, speakers) each."""
    m = pipe.model
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    out = []
    for k in range(0, len(order), BATCH):
        toks = m.tokenize_batch([prompts[i] for i in order[k: k + BATCH]])
        padded, lens, spk, _, _ = m._sorted_batch(toks, 0, BATCH)
        out.append((padded, lens, spk))
    return out


def t2_bound_us(pipe, batch: tuple) -> tuple[float, float, int]:
    """Least device time (us) of one decoder step at this batch in f32:
    the bytes of the decoder's weights read once, the step's memory and
    attention inputs read once and its state written once, at the memory
    rate; and the step's matmul FLOPs at the f32 peak. -> (bytes bound,
    operations bound, weight bytes)."""
    d = pipe.model.model.decoder
    n_w = sum(p.numel() for n, p in d.named_parameters()
              if "memory_layer" not in n)
    c = pipe.model.config
    B, T = batch[0].shape
    act = B * T * (c.memory_dim + c.attention_hidden_dim) + B * (
        4 * c.decoder_rnn_dim + 2 * T + c.memory_dim + c.n_mels)
    nbytes = 4 * (n_w + act)
    flops = 2 * B * n_w + 2 * B * T * (
        c.attention_location_n_filters * (
            2 * c.attention_location_kernel_size + c.attention_hidden_dim)
        + c.attention_hidden_dim + c.memory_dim)
    return (nbytes / PEAK_BYTES * 1e6, flops / PEAK_FLOPS[torch.float32]
            * 1e6, 4 * n_w)


def t2_decode_ms(pipe, batch: tuple, reps: int = 2) -> tuple[float, float]:
    """One decode of the batch at the pipeline's cap (replaying its graph
    when one is captured): (wall ms on the host clock, device ms between
    CUDA events), the min of `reps`."""
    walls, devs = [], []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        pipe.model._infer(*batch)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        devs.append(start.elapsed_time(end))
    return min(walls), min(devs)


def _t2_ragged_gate(logits: np.ndarray, cap: int):
    """From a capped decode's gate logits [B, S] at bias 0 (the gate does
    not feed back into the decode): the scale and bias of a gate under
    which the rows stop at distinct steps before the cap, each crossing
    more than 1e-2 from the threshold; the random decode settles with its
    logits falling, so the weight is negated. -> (scale, bias, stops)."""
    best = None
    for scale in (-100.0, 100.0):
        z = scale * logits
        values = np.unique(np.round(z, 3))
        for theta in (values[1:] + values[:-1]) / 2:
            stops = []
            for row in z:
                hit = np.flatnonzero(row > theta)
                stops.append(int(hit[0]) if hit.size else cap)
            margin = min(np.abs(row[: s + 1] - theta).min()
                         for row, s in zip(z, stops))
            if max(stops) < cap and margin > 1e-2:
                score = (len(set(stops)), min(stops), max(stops))
                if best is None or score > best[0]:
                    best = (score, scale, float(-theta), stops)
    if best is None or best[0][0] < 2:
        raise AssertionError("no gate stops the rows ragged before the cap")
    return best[1:]


def t2_profile_decode(pipe, batch: tuple, steps: int) -> dict:
    """One decode of the batch under torch.profiler: the device's idle
    share of its wall, device ms per step, and the top device ops."""
    got = profiled(lambda: pipe.model._infer(*batch))
    if got is None:
        return {}
    wall, by_name, busy, n_ops = got
    return dict(wall_ms=wall * 1e3, busy_ms=busy, idle=1 - busy / 1e3 / wall,
                dev_us_step=sum(by_name.values()) / steps * 1e3,
                ops_step=n_ops / steps, top=by_name.most_common(8))


def stage_kernel_times(calls: list, dtype, seed: int) -> tuple[dict, list]:
    """The ResBlock kernels in `dtype` at the stage shapes of generator
    calls (`calls`: their mel shapes; a shape that recurs is timed once and
    counted for each call), on seeded inputs: each held against the plain
    version in f32 (TOL), then timed beside the plain version on the same
    inputs (in `dtype`; f32 with the caller's TF32 setting) and its bound.
    Returns per variant ms, plain_ms, bound_ms (f32 also cuda_core_ms) and
    max_abs_err summed over the calls' stages (errors: the largest), and
    a line per shape."""
    from tts_arabic_torch.ops import resblock as rb
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dtype == torch.float32
    out, rows = {}, []
    for (b, f), n in collections.Counter(
            (b, f) for b, f, _ in calls).items():
        for C, per_frame in STAGE_T.items():
            name, T = rb.variant(C), f * per_frame
            for k in KERNEL_SIZES:
                args, err, rel = _rel_err(rb, name, C, k, T, dtype, gen, b)
                got = dict(ms=cuda_ms(lambda: _launch(rb, name, *args, k)),
                           plain_ms=cuda_ms(lambda: rb.resblock1_plain(
                               *args, k, DILATIONS)),
                           bound_ms=max(bound(C, k, T, dtype, batch=b)))
                if f32:
                    got["cuda_core_ms"] = cuda_core_ms(C, k, T, b)
                s = out.setdefault(name, dict.fromkeys(got, 0.0))
                for key, v in got.items():
                    s[key] += n * v
                s["max_abs_err"] = max(s.get("max_abs_err", 0.0), err)
                rows.append(f"{name[10:]} C={C} k={k} [{b}, {T}] x{n} err "
                            f"{rel:.2e} {got['ms']:.3f}/{got['plain_ms']:.3f}"
                            f"/{got['bound_ms']:.3f}"
                            + (f"/{got['cuda_core_ms']:.3f}" if f32 else ""))
                del args
    torch.cuda.empty_cache()
    return out, rows


def phase_tacotron2(smi: str) -> dict:
    """Tacotron2Wave.tts() of the 16 prompts at full width in f32, batch 8,
    with the decode-block graphs of its two batches captured by warmup():
    three timed calls (the launch counters set to 0 just before the last
    and read just after), the decode alone per step against its bound,
    graphed and eager, a DECODE_BLOCK sweep, a ragged-stop batch, one
    tts() under torch.profiler, fused = host path, the kernels against
    the plain ResBlocks, the f32 kernels timed at the generator calls'
    stage shapes beside the plain version (cuDNN f32, TF32 off), stream()
    against tts_single(postprocess_mel=False); returns the ResBlock
    launches of the counted tts(), its real-time factor and the kernels'
    times (`stage_kernel_times`)."""
    from tts_arabic_torch.models import tacotron2 as t2
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    set_tf32(False)
    prompts = load_prompts(N_PROMPTS)
    pipe = t2_pipe()
    m = pipe.model
    cap = m.decoder_max_step
    batches = t2_batches(pipe, prompts)
    buckets = sorted({b[0].shape[1] for b in batches})
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    m.capture_graphs((BATCH,), tuple(buckets))
    capture_s = time.perf_counter() - t0
    graph_mib = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    t0 = time.perf_counter()
    pipe.warmup(batch_sizes=(BATCH,), text_buckets=tuple(buckets))
    warm_s = time.perf_counter() - t0
    kw = dict(batch_size=BATCH, denoise=0.005)
    walls = []
    for i in range(N_TIMED - 1):
        t0 = time.perf_counter()
        pipe.tts(prompts, **kw)
        walls.append(time.perf_counter() - t0)
    with generator_calls() as calls:
        rb.reset_launches()
        mas_ops.reset_launches()
        replays = m.graph_replays
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, **kw)
        walls.append(time.perf_counter() - t0)
        launches = dict(rb.LAUNCHES)
    replays = m.graph_replays - replays
    want = {"resblock1_wide": 27 * len(batches),
            "resblock1_narrow": 3 * len(batches)}
    if launches != want or mas_ops.LAUNCHES["mas"]:
        raise AssertionError(f"Tacotron2 tts() launches {launches}, "
                             f"expected {want}, mas 0")
    # the ResBlock kernels' f32 bounds over this tts()'s generator calls:
    # 3xTF32's, and the CUDA cores'
    rb_bound, rb_cc = collections.Counter(), collections.Counter()
    for B, F, _ in calls:
        for C, per_frame in STAGE_T.items():
            for k in KERNEL_SIZES:
                rb_bound[rb.variant(C)] += max(bound(
                    C, k, F * per_frame, torch.float32, batch=B))
                rb_cc[rb.variant(C)] += cuda_core_ms(C, k, F * per_frame, B)
    frames = [len(w) // pipe.hop_length for w in waves]
    for i, w in enumerate(waves):
        if not (w.ndim == 1 and w.size and np.isfinite(w).all()
                and w.size % pipe.hop_length == 0):
            raise AssertionError(f"Tacotron2 prompt {i}: bad wave")
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    log(f"[12 tacotron2 tts] full width (512/1024/1024, postnet 5 x 512), "
        f"f32, HiFi-GAN V1 f32, {len(prompts)} prompts, batch {BATCH}, "
        f"decoder_max_step {cap}, DECODE_BLOCK {t2.DECODE_BLOCK}: "
        f"capture_graphs() at batch {BATCH}, text {buckets}: "
        f"{capture_s:.2f} s, {graph_mib:.1f} MiB; warmup()'s fused calls "
        f"{warm_s:.2f} s | tts() {audio_s:.2f} s of "
        f"audio: walls {', '.join(f'{w:.3f}' for w in walls)} s = "
        f"{audio_s / walls[-1]:.1f}x real time | {replays} block replays | "
        f"generator calls (mel shapes) {calls} | launches {launches}, mas 0 "
        f"| frames per prompt {frames} | {smi}")

    # the decode alone, per step, graphed and eager
    ragged_batch = batches[-1]
    b_us, o_us, w_bytes = t2_bound_us(pipe, ragged_batch)
    wall_ms, dev_ms = t2_decode_ms(pipe, ragged_batch)
    graphed = t2_profile_decode(pipe, ragged_batch, cap)
    eager_cap = 300
    with mock.patch.dict(m._graphs, clear=True), \
            mock.patch.object(m, "decoder_max_step", eager_cap):
        e_wall, e_dev = t2_decode_ms(pipe, ragged_batch, reps=1)
        eager_p = t2_profile_decode(pipe, ragged_batch, eager_cap)
    log(f"[12 tacotron2 decode] batch {BATCH} x text "
        f"{ragged_batch[0].shape[1]}, f32: graphed {cap} steps "
        f"{wall_ms:.1f} ms wall, {dev_ms:.1f} ms device = "
        f"{wall_ms / cap * 1e3:.1f} / {dev_ms / cap * 1e3:.1f} us a step; "
        f"eager ({eager_cap} steps) {e_wall / eager_cap * 1e3:.1f} / "
        f"{e_dev / eager_cap * 1e3:.1f} us a step | bound a step "
        f"{max(b_us, o_us):.2f} us (bytes {b_us:.2f}: {w_bytes / 1e6:.1f} MB "
        f"of weights; operations {o_us:.2f}) | {smi}")
    for label, p in (("graphed", graphed), ("eager", eager_p)):
        if not p:
            log(f"    profile {label}: no device events recorded, not "
                "measured")
            continue
        log(f"    profile {label}: wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['busy_ms']:.1f} ms, idle {100 * p['idle']:.1f}% of the "
            f"wall, device {p['dev_us_step']:.1f} us and "
            f"{p['ops_step']:.1f} ops a step | top: "
            + "; ".join(f"{n} {v:.1f} ms" for n, v in p["top"]))

    # DECODE_BLOCK: the host reads the run flag once per block
    sweep = []
    with mock.patch.object(m, "decoder_max_step", 600), \
            mock.patch.dict(m._graphs, clear=True):
        for K in (4, 8, 16, 32, 64):
            with mock.patch.object(t2, "DECODE_BLOCK", K):
                m._graphs.clear()
                m.capture_graphs((BATCH,), (ragged_batch[0].shape[1],))
                w_ms, d_ms = t2_decode_ms(pipe, ragged_batch)
                sweep.append(f"K={K} {w_ms / 600 * 1e3:.1f}/"
                             f"{d_ms / 600 * 1e3:.1f}")
        m._graphs.clear()
    log(f"    DECODE_BLOCK sweep, graphed, 600 steps, us a step wall/device:"
        f" {'; '.join(sweep)}")

    # rows that stop ragged: the gate set from this batch's capped logits
    gate = m.model.decoder.gate_layer.linear_layer
    saved = (gate.weight.detach().clone(), gate.bias.detach().clone())
    with torch.no_grad():
        gate.bias.fill_(-100.0)
    logits = m._infer(*ragged_batch)["gates"].cpu().numpy() + 100.0
    scale, bias, stops = _t2_ragged_gate(logits, cap)
    with torch.no_grad():
        gate.weight.copy_(saved[0] * scale)
        gate.bias.fill_(bias)
    try:
        t0 = time.perf_counter()
        got = m._infer(*ragged_batch)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        with mock.patch.dict(m._graphs, clear=True):
            t0 = time.perf_counter()
            ref = m._infer(*ragged_batch)
            torch.cuda.synchronize()
            e_s = time.perf_counter() - t0
    finally:
        with torch.no_grad():
            gate.weight.copy_(saved[0])
            gate.bias.copy_(saved[1])
    lens = got["mel_lens"].tolist()
    err = float((got["mel"] - ref["mel"]).abs().max())
    if (lens != ref["mel_lens"].tolist() or lens != [s + 1 for s in stops]
            or len(set(lens)) < 2 or not err <= 1e-5):
        raise AssertionError(f"ragged decode: graphed {lens}, eager "
                             f"{ref['mel_lens'].tolist()}, predicted "
                             f"{[s + 1 for s in stops]}, mel err {err:.2e}")
    log(f"[12 tacotron2 ragged] gate weight x {scale:g}, bias {bias:.4f} "
        f"(from the capped decode's logits): rows stop at {lens} (the "
        f"recorded logits' prediction), graphed = eager, max|mel| err "
        f"{err:.2e}; graphed {g_s * 1e3:.1f} ms, eager {e_s * 1e3:.1f} ms")

    # one more tts() under the profiler: the ResBlocks' share
    got = profiled(lambda: pipe.tts(prompts, **kw))
    if got is None:
        log(f"[12 tacotron2 profile] no device events recorded, not "
            f"measured | {smi}")
    else:
        wall, by_name, busy, n_ops = got
        rb_ms = sum(v for n, v in by_name.items() if "resblock1" in n)
        wide_ms = sum(v for n, v in by_name.items()
                      if "resblock1_pass" in n)
        dev = sum(by_name.values())
        log(f"[12 tacotron2 profile] tts() under torch.profiler: wall "
            f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms (idle "
            f"{100 * (1 - busy / 1e3 / wall):.1f}%), {n_ops} device ops "
            f"summing {dev:.1f} ms | ResBlock kernels {rb_ms:.1f} ms = "
            f"{100 * rb_ms / dev:.1f}% of the device time, "
            f"{100 * rb_ms / 1e3 / wall:.1f}% of the wall: wide (f32, "
            f"3xTF32) {wide_ms:.1f} ms, bound "
            f"{rb_bound['resblock1_wide']:.1f} (CUDA cores "
            f"{rb_cc['resblock1_wide']:.1f}); narrow (f32) "
            f"{rb_ms - wide_ms:.1f} ms, bound "
            f"{rb_bound['resblock1_narrow']:.1f} (CUDA cores "
            f"{rb_cc['resblock1_narrow']:.1f}) | top: "
            + "; ".join(f"{n} {v:.1f} ms" for n, v in by_name.most_common(8))
            + f" | {smi}")

    # fused path = host path, on the first batch
    first = sorted(prompts, key=len, reverse=True)[:BATCH]
    fused = pipe.tts(first, **kw)
    host, mels = pipe.tts_batch(first, pad_to=BATCH, denoise=0.005,
                                return_mel=True)
    worst = 0.0
    for f, h in zip(fused, host):
        if f.shape != h.shape:
            raise AssertionError(f"fused {f.shape} vs host {h.shape}")
        worst = max(worst, float(np.abs(f - h).max()))
    if not worst <= 1e-4:
        raise AssertionError(f"fused vs host path: {worst:.2e}")
    # the kernels against the plain ResBlocks, on the host path's mels
    wave_k, lens_k = pipe._dispatch_vocode(mels, 0.005)
    with mock.patch.object(hifigan, "resblock1", rb.resblock1_plain):
        wave_p, _ = pipe._dispatch_vocode(mels, 0.005)
    snrs = [snr_db(p, k) for k, p in zip(pipe._split_waves(wave_k, lens_k),
                                         pipe._split_waves(wave_p, lens_k))]
    if not min(snrs) > SNR_GATE[torch.float32]:
        raise AssertionError(f"Tacotron2 vocoder SNR {snrs}")
    log(f"[12 tacotron2 checks] fused path = host path within {worst:.2e} "
        f"(8 prompts, lengths equal) | kernels vs plain ResBlocks on those "
        f"mels: SNR min {min(snrs):.2f} dB (> {SNR_GATE[torch.float32]})")

    # the f32 kernels at this tts()'s stage shapes, beside cuDNN's f32
    timed, rows = stage_kernel_times(calls, torch.float32, 12)
    log(f"[12 tacotron2 kernels] f32 (3xTF32 tensor cores) at the "
        f"generator calls' stage shapes, seeded inputs, {tf32_state()}, err "
        f"= max|kernel - plain| / max|plain| (<= {TOL[torch.float32]:.0e}), "
        f"kernel/plain/bound/CUDA-core bound ms: " + "; ".join(rows) + " | "
        + "; ".join(f"{n}: {v['ms']:.1f} ms for its {launches[n]} launches "
                    f"(plain cuDNN f32 {v['plain_ms']:.1f}, bound "
                    f"{v['bound_ms']:.1f} = "
                    f"{100 * v['bound_ms'] / v['ms']:.1f}%, CUDA-core bound "
                    f"{v['cuda_core_ms']:.1f})"
                    for n, v in timed.items()) + f" | {smi}")

    # stream() against tts_single(postprocess_mel=False), one row
    text = min(prompts, key=len)
    n_ids = len(m.tokenize(text))
    m.capture_graphs((1,), (-(-n_ids // 16) * 16,))
    ref = pipe.tts_single(text, denoise=0.005, postprocess_mel=False)
    firsts, fulls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        gen = pipe.stream(text, denoise=0.005)
        chunks = [next(gen)]
        firsts.append(time.perf_counter() - t0)
        chunks += list(gen)
        t0 = time.perf_counter()
        pipe.tts_single(text, denoise=0.005, postprocess_mel=False)
        fulls.append(time.perf_counter() - t0)
    streamed = np.concatenate(chunks)
    err = float(np.abs(streamed - ref).max()) if streamed.shape == \
        ref.shape else float("inf")
    if not err <= 1e-4:
        raise AssertionError(f"Tacotron2 stream vs tts_single: {err}")
    log(f"[12 tacotron2 stream] one row ({n_ids} tokens, {len(ref) // 256} "
        f"frames, {len(chunks)} chunks of 96): max|stream - tts_single"
        f"(postprocess_mel=False)| {err:.2e} | first chunk "
        f"{min(firsts) * 1e3:.1f} ms against the whole call "
        f"{min(fulls) * 1e3:.1f} ms (min of 3, both replaying the graphs) "
        f"| {smi}")
    del pipe, m, waves, fused, host, mels
    torch.cuda.empty_cache()
    return launches, audio_s / walls[-1], timed


def phase_tacotron2_apps(smi: str, tmp: pathlib.Path) -> None:
    """The inference CLI with --model tacotron2 on 8 prompts from a
    reference `.pth` (f32, no graphs: each decode eager) against the same
    weights' tts(speed=1.0) within 1 LSB; then the server with a tacotron2
    registry entry after its warmup(): /api/tts, /api/tts/stream equal to
    the model's own stream(), and a 400 for a rate other than 1."""
    import threading
    from http.server import ThreadingHTTPServer

    from scipy.io import wavfile

    from tts_arabic_torch.apps import inference, server
    prompts = load_prompts(BATCH)
    pipe = t2_pipe()
    pipe.model.capture_graphs((BATCH,), (t2_batches(pipe, prompts)[0][0]
                                         .shape[1],))
    pth = tmp / "tacotron2.pth"
    torch.save({"model": pipe.model.model.state_dict()}, pth)
    lst = tmp / "prompts.txt"
    lst.write_text("\n".join(prompts) + "\n", encoding="utf-8")
    out_dir = tmp / "samples"
    t0 = time.perf_counter()
    inference.main(["--model", "tacotron2", "--list", str(lst),
                    "--buckwalter", "--checkpoint", str(pth), "--out-dir",
                    str(out_dir), "--batch-size", str(BATCH)])
    cli_s = time.perf_counter() - t0
    want = pipe.tts(prompts, speed=1.0, batch_size=BATCH, denoise=0.005)
    worst = 0
    for i, w in enumerate(want):
        _, got = wavfile.read(out_dir / f"wave_{i:04d}.wav")
        w16 = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
        if got.shape != w16.shape:
            raise AssertionError(f"CLI wave {i}: {got.shape} vs {w16.shape}")
        worst = max(worst, int(np.abs(got.astype(np.int32) - w16).max()))
    if worst > 1:
        raise AssertionError(f"Tacotron2 CLI waves off by {worst} LSB")
    log(f"[13 tacotron2 CLI] --model tacotron2, {len(prompts)} prompts from "
        f"a .pth, f32, batch {BATCH}: {cli_s:.2f} s wall (model load and "
        f"eager decodes included) | wavs within {worst} LSB of tts() | {smi}")
    del pipe

    manager = server.TTSManager([{"name": "tacotron2-f32",
                                  "type": "tacotron2"}], device="cuda")
    _, model = manager.models[0]
    warm_s = manager.warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(manager))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    text = "wa*alika biHuDuwri"   # within the warmed text bucket of 32
    try:
        conn, resp = _post(port, "/api/tts", {"buckw": text, "rate": 1.0})
        waves = json.loads(resp.read())["waves"]
        conn.close()
        if resp.status != 200:
            raise AssertionError(f"/api/tts: {resp.status}")
        replays = model.model.graph_replays
        t0 = time.perf_counter()
        conn, resp = _post(port, "/api/tts/stream", {"buckw": text})
        head = resp.read(2)
        ttfb = time.perf_counter() - t0
        got = head + resp.read()
        conn.close()
        replays = model.model.graph_replays - replays
        want = b"".join(np.asarray(c).tobytes() for c in model.stream(
            text, denoise=0.005, out_int16=True))
        if resp.status != 200 or got != want or not replays:
            raise AssertionError(f"/api/tts/stream: {resp.status}, "
                                 f"{len(got)} vs {len(want)} bytes, "
                                 f"{replays} replays")
        conn, resp = _post(port, "/api/tts/stream",
                           {"buckw": text, "rate": 1.25})
        body = resp.read()
        conn.close()
        if resp.status != 400 or b"tacotron2" not in body:
            raise AssertionError(f"rate 1.25 on the stream: {resp.status}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    log(f"[13 tacotron2 server] registry of one full-width f32 Tacotron2: "
        f"warmup() {warm_s:.2f} s | /api/tts wrote {waves[0]['url']} | "
        f"/api/tts/stream {len(got)} bytes = the model's stream(), "
        f"{replays} block replays, first byte {ttfb * 1e3:.1f} ms | "
        f"rate 1.25 on the stream: 400 | {smi}")
    del manager, model
    torch.cuda.empty_cache()


# ---- the int8 and Vocos slice -----------------------------------------------

def duration_bias():
    """FastPitchTTS objects built inside get make_pipe's +2.0 duration
    bias at the end of their constructor, so a pipeline that calibrates in
    its constructor (quantize="int8") decodes realistic lengths."""
    from tts_arabic_torch.infer import pipeline as pl
    init = pl.FastPitchTTS.__init__

    def biased(self, *a, **kw):
        init(self, *a, **kw)
        with torch.no_grad():
            self.model.duration_predictor.fc.bias.add_(2.0)
    return mock.patch.object(pl.FastPitchTTS, "__init__", biased)


@contextlib.contextmanager
def float_path(pipe):
    """pipe's float vocoder and decoder FFN while the block runs (its
    int8 scales set aside; a float decode finds no int8 graph)."""
    vocode = pipe._vocode
    ffn = getattr(pipe, "_ffn_scales", None)
    pipe._vocode = pipe.vocoder
    if ffn is not None:
        pipe._ffn_scales = None
    try:
        yield
    finally:
        pipe._vocode = vocode
        if ffn is not None:
            pipe._ffn_scales = ffn


def oracle_checked(records: list):
    """Every `ops.int8.int8_conv_acc` call inside also computed in float64
    on the card from the same int8 grids (exact for integers below 2^53):
    records (input shape, C_out, k, dilation, equal)."""
    import torch.nn.functional as F

    from tts_arabic_torch.ops import int8 as i8
    acc_fn = i8.int8_conv_acc

    def checked(xq, wq, k, d):
        acc = acc_fn(xq, wq, k, d)
        C = xq.shape[-1]
        w = wq.reshape(wq.shape[0], k, C).permute(0, 2, 1).double()
        ref = F.conv1d(xq.double().transpose(1, 2), w, dilation=d,
                       padding=d * (k - 1) // 2).transpose(1, 2)
        records.append((tuple(xq.shape), wq.shape[0], k, d,
                        bool(torch.equal(acc.double(), ref))))
        return acc
    return mock.patch.object(i8, "int8_conv_acc", checked)


def int8_conv_ms(fn) -> tuple[float, int]:
    """Every `int8_conv_static` call of fn(), recorded (its input, weight,
    bias, dilation and scale) and then timed alone at that shape with CUDA
    events: (the sum of their device ms, the number of calls)."""
    from tts_arabic_torch.ops import hifigan_int8 as h8
    from tts_arabic_torch.ops import int8 as i8
    conv, calls = i8.int8_conv_static, []

    def recorded(*a):
        calls.append(a)
        return conv(*a)

    with mock.patch.object(i8, "int8_conv_static", recorded), \
            mock.patch.object(h8, "int8_conv_static", recorded):
        fn()
    total = sum(cuda_ms(lambda: conv(*a)) for a in calls)
    return total, len(calls)


def save_checkpoint(pipe, tmp: pathlib.Path) -> pathlib.Path:
    """pipe's FastPitch as a `states.ckpt` of the trainer's format."""
    from tts_arabic_torch.runtime.checkpoint import save_states
    ckpt = tmp / "states.ckpt"
    save_states(ckpt, config={
        "net_config": pipe.model.config.to_reference_net_config()},
        model=pipe.model.model.state_dict())
    return ckpt


def phase_int8(smi: str, bf16_rtf: float, tmp: pathlib.Path) -> dict:
    """FastPitch2Wave(quantize="int8") at full width in bf16 (phase 4's
    configuration, its constructor calibrating on the built-in texts),
    after warmup(): three timed tts() of the 16 prompts (the launch
    counters set to 0 just before the last and read just after), one
    under torch.profiler (idle share) and the int8 convs of one more,
    each timed alone at its shape (their share of device time); every
    int8 conv of one tts() against the float64 conv of its grids; the
    generator against its plain ResBlocks with the same scales; the float
    path's waves for information; calibrate_int8() after warmup()
    (graphed = eager int8, stream() against tts_single); then the
    inference CLI with --quantize int8 and the server with a `quantize:
    int8` entry. Returns the counted tts()'s ResBlock launches."""
    from tts_arabic_torch.infer import FastPitch2Wave
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    prompts = load_prompts(N_PROMPTS)
    kw = dict(batch_size=BATCH, denoise=0.005)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with duration_bias():
        pipe = FastPitch2Wave(seed=0, arabic_in=False, device="cuda",
                              compute_dtype=torch.bfloat16, quantize="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sites, ffn = len(pipe._int8_scales), len(pipe._ffn_scales)
    if (sites, ffn) != (54, pipe.model.config.dec_n_layers):
        raise AssertionError(f"{sites} MRF sites, {ffn} FFN layers")
    t0 = time.perf_counter()
    pipe.warmup()
    warm_s = time.perf_counter() - t0
    walls = []
    for _ in range(N_TIMED - 1):
        t0 = time.perf_counter()
        pipe.tts(prompts, **kw)
        walls.append(time.perf_counter() - t0)
    with generator_calls() as calls:
        rb.reset_launches()
        mas_ops.reset_launches()
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, **kw)
        walls.append(time.perf_counter() - t0)
        launches = dict(rb.LAUNCHES)
    expected = {"resblock1_wide": 0, "resblock1_narrow": 3 * len(calls)}
    if launches != expected or mas_ops.LAUNCHES["mas"]:
        raise AssertionError(f"int8 tts() launches {launches}, expected "
                             f"{expected}")
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    rtf = audio_s / walls[-1]
    with float_path(pipe):
        flt = pipe.tts(prompts, **kw)
    if [w.shape for w in waves] != [w.shape for w in flt]:
        raise AssertionError("int8 and float tts() lengths differ")
    snr_float = [snr_db(f, w) for f, w in zip(flt, waves)]
    log(f"[14 int8] FastPitch2Wave(quantize='int8'), bf16, full width: "
        f"constructor {build_s:.2f} s (calibration on the built-in texts "
        f"included: {sites} MRF sites, {ffn} decoder FFN layers) | "
        f"warmup() {warm_s:.2f} s | tts() of {len(prompts)} prompts, batch "
        f"{BATCH}: {audio_s:.2f} s of audio in {walls[-1]:.3f} s = "
        f"{rtf:.1f}x real time (phase 4, bf16: {bf16_rtf:.1f}x; the "
        f"{N_TIMED} calls {', '.join(f'{w:.3f}' for w in walls)} s) | "
        f"launches {launches} over {len(calls)} generator calls, mas 0 | "
        f"SNR against the float path (information) min "
        f"{min(snr_float):.2f}, median {np.median(snr_float):.2f} dB | "
        f"{smi}")

    got = profiled(lambda: pipe.tts(prompts, **kw))
    conv_ms, n_convs = int8_conv_ms(lambda: pipe.tts(prompts, **kw))
    if got is None:
        log(f"[14 int8 profile] no device events recorded: idle share not "
            f"measured | the {n_convs} int8 convs of one tts(), each timed "
            f"alone at its shape: {conv_ms:.2f} ms | {smi}")
    else:
        wall, by_name, busy, n_ops = got
        rb_ms = sum(v for n, v in by_name.items() if "resblock1" in n)
        top = [(n, v) for n, v in by_name.most_common()
               if "resblock1" not in n]
        log(f"[14 int8 profile] tts() under torch.profiler: wall "
            f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms (idle "
            f"{100 * (1 - busy / 1e3 / wall):.1f}% of the wall), {n_ops} "
            f"device ops summing {sum(by_name.values()):.1f} ms | narrow "
            f"ResBlock kernel {rb_ms:.2f} ms | the {n_convs} int8 convs of "
            f"one tts() (quantize, tap unfold, s8 GEMM, dequantize), each "
            f"timed alone at its shape: {conv_ms:.2f} ms = "
            f"{100 * conv_ms / sum(by_name.values()):.1f}% of the profiled "
            f"device time | top ops: " + "; ".join(
                f"{n} {v:.2f} ms" for n, v in top[:8]) + f" | {smi}")

    records = []
    with oracle_checked(records):
        pipe.tts(prompts, **kw)
    # the 54 MRF convs in each generator call (a length group), the
    # decoder FFN's 2 a layer in each batch's one decode
    n_batches = -(-len(prompts) // BATCH)
    want = len(calls) * 54 + n_batches * 2 * ffn
    bad = [r for r in records if not r[-1]]
    if bad or len(records) != want:
        raise AssertionError(f"int8 convs vs the float64 oracle: "
                             f"{len(records)} calls (expected {want}), "
                             f"unequal {bad[:4]}")
    shapes = sorted({r[:4] for r in records})
    kern = [pipe.tts_single(p, denoise=0.005) for p in prompts[:2]]
    with mock.patch.object(hifigan, "resblock1", _plain_f32):
        plain = [pipe.tts_single(p, denoise=0.005) for p in prompts[:2]]
    snrs = [snr_db(b, a) for a, b in zip(kern, plain)]
    log(f"[14 int8 checks] every int8 conv of one tts() ({len(records)} "
        f"calls, {len(shapes)} shapes from {shapes[0]} to {shapes[-1]}): "
        f"int32 accumulators = the float64 conv of the same grids | the "
        f"int8 generator (narrow ResBlock kernel) against its plain "
        f"ResBlocks in f32 with the same scales, tts_single x2: SNR "
        f"{', '.join(f'{s:.2f}' for s in snrs)} dB (> {INT8_SNR_GATE}) | "
        f"{smi}")
    if not min(snrs) > INT8_SNR_GATE:
        raise AssertionError(f"int8 generator vs plain: {snrs}")

    t0 = time.perf_counter()
    pipe.calibrate_int8()
    torch.cuda.synchronize()
    recal_s = time.perf_counter() - t0
    keys = [k for k in pipe.model._graphs if k[0] == "decode"]
    if not keys or not all(k[-1] for k in keys):
        raise AssertionError("decoder graphs not captured again in int8")
    text = prompts[0]
    replays = pipe.model.graph_replays
    graphed = pipe.tts_single(text, denoise=0.005)
    replays = pipe.model.graph_replays - replays
    with eager(pipe):
        eager_wave = pipe.tts_single(text, denoise=0.005)
    if replays != 2 or not np.array_equal(graphed, eager_wave):
        raise AssertionError(f"graphed int8 tts_single ({replays} replays) "
                             "differs from the eager one")
    rb.reset_launches()
    chunks = list(pipe.stream(text, chunk_frames=STREAM_CHUNK,
                              overlap=STREAM_OVERLAP, denoise=0.005))
    stream_launches = dict(rb.LAUNCHES)
    streamed = np.concatenate(chunks)
    if streamed.shape != graphed.shape or stream_launches != {
            "resblock1_wide": 0, "resblock1_narrow": 3 * len(chunks)}:
        raise AssertionError(f"int8 stream: {streamed.shape} vs "
                             f"{graphed.shape}, launches {stream_launches}")
    s_snr = snr_db(graphed, streamed)
    log(f"[14 int8 recalibrate] warmup() then calibrate_int8(): "
        f"{recal_s:.2f} s, {len(pipe.model._graphs)} graphs captured again "
        f"({len(keys)} int8 decoders) | graphed tts_single = the eager int8 "
        f"call ({replays} replays) | stream() of prompt 0, {len(chunks)} "
        f"chunks, launches {stream_launches}: SNR {s_snr:.2f} dB against "
        f"tts_single (> {INT8_STREAM_SNR}), max |diff| "
        f"{np.abs(streamed - graphed).max():.3e} of peak "
        f"{np.abs(graphed).max():.3e} | {smi}")
    if not s_snr > INT8_STREAM_SNR:
        raise AssertionError(f"int8 stream SNR {s_snr:.2f}")
    ckpt = save_checkpoint(pipe, tmp)
    del pipe
    torch.cuda.empty_cache()
    phase_int8_apps(smi, ckpt, prompts, tmp)
    return launches


def phase_int8_apps(smi: str, ckpt: pathlib.Path, prompts: list[str],
                    tmp: pathlib.Path) -> None:
    """The server with one `quantize: int8` bf16 entry from `ckpt`, after
    its warmup(): /api/tts writes a wav and /api/tts/stream gives the
    model's own stream(); then the inference CLI with --quantize int8 on
    the 16 prompts, within 1 LSB of the served model's tts()."""
    import threading
    from http.server import ThreadingHTTPServer

    from scipy.io import wavfile

    from tts_arabic_torch.apps import inference, server
    manager = server.TTSManager([{
        "name": "fastpitch-int8", "type": "fastpitch", "quantize": "int8",
        "compute_dtype": "bfloat16", "checkpoint": str(ckpt)}],
        device="cuda")
    _, model = manager.models[0]
    if model._int8_scales is None or model._ffn_scales is None:
        raise AssertionError("the registry's int8 entry is not int8")
    warm_s = manager.warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(manager))
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    text = prompts[1]
    try:
        conn, resp = _post(port, "/api/tts", {"buckw": text})
        waves = json.loads(resp.read())["waves"]
        conn.close()
        if resp.status != 200:
            raise AssertionError(f"/api/tts: {resp.status}")
        t0 = time.perf_counter()
        conn, resp = _post(port, "/api/tts/stream",
                           {"buckw": text, "rate": 1.1})
        head = resp.read(2)
        ttfb = time.perf_counter() - t0
        got = head + resp.read()
        conn.close()
        want = b"".join(np.asarray(c).tobytes() for c in model.stream(
            text, speed=1.1, denoise=0.005, out_int16=True))
        if resp.status != 200 or got != want:
            raise AssertionError(f"int8 /api/tts/stream: {resp.status}, "
                                 f"{len(got)} vs {len(want)} bytes")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    lst = tmp / "prompts.txt"
    lst.write_text("\n".join(prompts) + "\n", encoding="utf-8")
    out_dir = tmp / "samples_int8"
    t0 = time.perf_counter()
    inference.main(["--list", str(lst), "--buckwalter", "--checkpoint",
                    str(ckpt), "--out-dir", str(out_dir), "--batch-size",
                    str(BATCH), "--quantize", "int8"])
    cli_s = time.perf_counter() - t0
    want = model.tts(prompts, batch_size=BATCH, denoise=0.005)
    worst = 0
    for i, w in enumerate(want):
        _, got_w = wavfile.read(out_dir / f"wave_{i:04d}.wav")
        w16 = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
        if got_w.shape != w16.shape:
            raise AssertionError(f"int8 CLI wave {i}: {got_w.shape} vs "
                                 f"{w16.shape}")
        worst = max(worst, int(np.abs(got_w.astype(np.int32) - w16).max()))
    if worst > 1:
        raise AssertionError(f"int8 CLI waves off by {worst} LSB")
    log(f"[14 int8 apps] server with a `quantize: int8` bf16 entry: "
        f"warmup() {warm_s:.2f} s (its calibration was at load) | /api/tts "
        f"wrote {waves[0]['url']} | /api/tts/stream at rate 1.1 = the "
        f"model's stream(), {len(got)} bytes, first byte "
        f"{ttfb * 1e3:.1f} ms | CLI --quantize int8 on {len(prompts)} "
        f"prompts: {cli_s:.2f} s wall (load and calibration included), wavs"
        f" within {worst} LSB of the served model's tts() | {smi}")
    del manager, model
    torch.cuda.empty_cache()


def phase_tacotron2_int8(smi: str) -> None:
    """Tacotron2Wave(quantize="int8") at full width in f32, its decodes
    capped at T2_INT8_STEPS (the constructor's calibration decodes
    included): warmup() of the two batches' decode graphs, tts() of the
    16 prompts (0 wide, 3 narrow launches per generator call), against the
    float vocoder's run of the same decodes (equal lengths; SNR for
    information), the int8 generator against its plain ResBlocks, and
    stream() after calibration against its own int8 tts_single."""
    from tts_arabic_torch.infer import tacotron_pipeline as tp
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    set_tf32(False)
    init = tp.Tacotron2TTS.__init__

    def capped(self, *a, **kw):
        kw.setdefault("decoder_max_step", T2_INT8_STEPS)
        init(self, *a, **kw)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(tp.Tacotron2TTS, "__init__", capped):
        pipe = t2_pipe(quantize="int8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if len(pipe._int8_scales) != 54:
        raise AssertionError(f"{len(pipe._int8_scales)} MRF sites")
    prompts = load_prompts(N_PROMPTS)
    buckets = sorted({b[0].shape[1] for b in t2_batches(pipe, prompts)})
    pipe.warmup(batch_sizes=(BATCH,), text_buckets=tuple(buckets))
    kw = dict(batch_size=BATCH, denoise=0.005)
    pipe.tts(prompts, **kw)
    with generator_calls() as calls:
        rb.reset_launches()
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, **kw)
        wall = time.perf_counter() - t0
        launches = dict(rb.LAUNCHES)
    if launches != {"resblock1_wide": 0,
                    "resblock1_narrow": 3 * len(calls)}:
        raise AssertionError(f"Tacotron2 int8 launches {launches}")
    with float_path(pipe):
        flt = pipe.tts(prompts, **kw)
    if [w.shape for w in waves] != [w.shape for w in flt]:
        raise AssertionError("Tacotron2 int8 and float lengths differ")
    snr_float = [snr_db(f, w) for f, w in zip(flt, waves)]
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    short = min(prompts, key=len)
    kern = pipe.tts_single(short, denoise=0.005)
    with mock.patch.object(hifigan, "resblock1", rb.resblock1_plain):
        plain = pipe.tts_single(short, denoise=0.005)
    p_snr = snr_db(plain, kern)
    full = pipe.tts_single(short, denoise=0.005, postprocess_mel=False)
    t0 = time.perf_counter()
    gen = pipe.stream(short, denoise=0.005)
    chunks = [next(gen)]
    first_s = time.perf_counter() - t0
    chunks += list(gen)
    streamed = np.concatenate(chunks)
    if streamed.shape != full.shape:
        raise AssertionError(f"Tacotron2 int8 stream {streamed.shape} vs "
                             f"{full.shape}")
    s_snr = snr_db(full, streamed)
    log(f"[15 tacotron2 int8] Tacotron2Wave(quantize='int8'), f32, full "
        f"width, decoder_max_step {T2_INT8_STEPS} (reduced from 3000; the "
        f"random gate never fires): constructor {build_s:.2f} s "
        f"(calibration decodes included, 54 MRF sites) | tts() of "
        f"{len(prompts)} prompts, batch {BATCH}: {audio_s:.2f} s of audio "
        f"in {wall:.3f} s = {audio_s / wall:.1f}x real time | launches "
        f"{launches} over {len(calls)} generator calls | lengths = the "
        f"float vocoder's run; SNR against it (information) min "
        f"{min(snr_float):.2f} dB | the int8 generator (narrow kernel) "
        f"against its plain ResBlocks, same scales: SNR {p_snr:.2f} dB "
        f"(> {INT8_SNR_GATE}) | stream() of the shortest prompt after "
        f"calibration, {len(chunks)} chunks, first in {first_s * 1e3:.1f} "
        f"ms: SNR {s_snr:.2f} dB against tts_single(postprocess_mel=False) "
        f"(> {INT8_T2_STREAM_SNR}), max |diff| "
        f"{np.abs(streamed - full).max():.3e} | {smi}")
    if not p_snr > INT8_SNR_GATE or not s_snr > INT8_T2_STREAM_SNR:
        raise AssertionError(f"Tacotron2 int8: plain SNR {p_snr:.2f}, "
                             f"stream SNR {s_snr:.2f}")
    del pipe
    torch.cuda.empty_cache()


def vocos_yaml(n_mels: int, dim: int, layers: int) -> str:
    """A reference-format Vocos hparams file (nested block mappings) of
    CONFIG_22K's shapes."""
    return (
        "feature_extractor:\n"
        "  class_path: vocos.feature_extractors.MelSpectrogramFeatures\n"
        "  init_args:\n    sample_rate: 22050\n    n_fft: 1024\n"
        f"    hop_length: 256\n    n_mels: {n_mels}\n    padding: same\n"
        "backbone:\n  class_path: vocos.models.VocosBackbone\n"
        f"  init_args:\n    input_channels: {n_mels}\n    dim: {dim}\n"
        f"    intermediate_dim: {3 * dim}\n    num_layers: {layers}\n"
        "head:\n  class_path: vocos.heads.ISTFTHead\n"
        f"  init_args:\n    dim: {dim}\n    n_fft: 1024\n"
        "    hop_length: 256\n    padding: same\n")


def phase_vocos(smi: str, hifigan_rtf: float, tmp: pathlib.Path) -> None:
    """FastPitch2Wave(vocoder_type="vocos") in bf16 (CONFIG_22K: dim 512,
    8 ConvNeXt layers of 1536; seeded), after warmup(): three timed tts()
    of the 16 prompts (no ResBlock or MAS launch in the last), one under
    torch.profiler; stream() against tts_single; the f32 Vocos on the card
    against the same weights on the CPU; MelVocos, and Vocos.from_hparams
    round-tripped through a YAML file and a `.pth`."""
    from tts_arabic_torch.infer import FastPitch2Wave
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import vocos as pv
    prompts = load_prompts(N_PROMPTS)
    kw = dict(batch_size=BATCH, denoise=0.005)
    pipe = FastPitch2Wave(seed=0, arabic_in=False, device="cuda",
                          compute_dtype=torch.bfloat16, vocoder_type="vocos")
    with torch.no_grad():
        pipe.model.model.duration_predictor.fc.bias.add_(2.0)
    t0 = time.perf_counter()
    pipe.warmup()
    warm_s = time.perf_counter() - t0
    walls = []
    for i in range(N_TIMED):
        if i == N_TIMED - 1:
            rb.reset_launches()
            mas_ops.reset_launches()
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, **kw)
        walls.append(time.perf_counter() - t0)
    launched = sum(rb.LAUNCHES.values()) + mas_ops.LAUNCHES["mas"]
    if launched:
        raise AssertionError(f"Vocos tts() launched {launched} kernels")
    mels = pipe.model.ttmel(prompts, batch_size=BATCH)
    for i, (w, m) in enumerate(zip(waves, mels)):
        if not (np.isfinite(w).all() and w.size == m.shape[1] * 256):
            raise AssertionError(f"Vocos wave {i}: {w.size} samples")
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    got = profiled(lambda: pipe.tts(prompts, **kw))
    prof = ("no device events recorded, breakdown not measured"
            if got is None else
            f"under torch.profiler: wall {got[0] * 1e3:.1f} ms, device busy"
            f" {got[2]:.1f} ms (idle {100 * (1 - got[2] / 1e3 / got[0]):.1f}"
            f"% of the wall), {got[3]} device ops, top: " + "; ".join(
                f"{n} {v:.2f} ms" for n, v in got[1].most_common(6)))
    log(f"[16 vocos] FastPitch2Wave(vocoder_type='vocos'), bf16, CONFIG_22K "
        f"(dim 512, 8 ConvNeXt layers, intermediate 1536), seeded: warmup() "
        f"{warm_s:.2f} s | tts() of {len(prompts)} prompts, batch {BATCH}: "
        f"{audio_s:.2f} s of audio in {walls[-1]:.3f} s = "
        f"{audio_s / walls[-1]:.1f}x real time (HiFi-GAN, phase 4: "
        f"{hifigan_rtf:.1f}x; the {N_TIMED} calls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s) | ResBlock and MAS "
        f"launches 0 | {prof} | {smi}")

    text = " ".join(prompts[:N_STREAM_PROMPTS])
    full = pipe.tts_single(text, denoise=0.005)
    chunks = list(pipe.stream(text, chunk_frames=STREAM_CHUNK,
                              overlap=STREAM_OVERLAP, denoise=0.005))
    streamed = np.concatenate(chunks)
    if streamed.shape != full.shape:
        raise AssertionError(f"Vocos stream {streamed.shape} vs "
                             f"{full.shape}")
    seam = np.abs(streamed - full).max()
    v_snr = snr_db(full, streamed)

    set_tf32(False)
    module = pipe.vocoder
    cpu = copy.deepcopy(module).cpu()
    mel = torch.from_numpy(np.ascontiguousarray(mels[0].T[None]))
    with torch.no_grad():
        want = cpu(mel, cpu.bias_vector(), 0.005)
        card = module(mel.cuda(), pipe.bias_spec, 0.005).cpu()
    f32_err = float((card - want).abs().max() / want.abs().max())
    mv = pv.MelVocos(seed=1, device="cuda")
    mv_wave = mv(mels[0], denoise=0.005)
    yaml_path = tmp / "vocos.yaml"
    yaml_path.write_text(vocos_yaml(80, 512, 8))
    pth = tmp / "vocos.pth"
    torch.save(module.state_dict(), pth)
    voc = pv.Vocos.from_hparams(yaml_path, pth, device="cuda")
    with torch.no_grad():
        direct = module(mel.cuda()).cpu().numpy()
    decoded = voc.decode(mel.transpose(1, 2).numpy())
    rt_err = float(np.abs(decoded - direct).max() / np.abs(direct).max())
    copy_wave = voc(full[None, : 256 * 200])
    log(f"[16 vocos checks] stream() of the first {N_STREAM_PROMPTS} prompts"
        f" joined, {len(chunks)} chunks of {STREAM_CHUNK} (overlap "
        f"{STREAM_OVERLAP}) against tts_single: max |diff| {seam:.3e} of "
        f"peak {np.abs(full).max():.3e}, SNR {v_snr:.2f} dB (> "
        f"{STREAM_BF16_SNR}) | f32 Vocos on the card vs the CPU, same "
        f"weights, {tuple(mel.shape)}: max err {f32_err:.2e} of the peak "
        f"(<= 1e-4) | MelVocos (seeded) -> {mv_wave.shape}, finite "
        f"{bool(np.isfinite(mv_wave).all())} | Vocos.from_hparams (YAML "
        f"with nested mappings + .pth): decode = the module within "
        f"{rt_err:.2e}; copy-synthesis -> {copy_wave.shape} | {smi}")
    if not (v_snr > STREAM_BF16_SNR and f32_err <= 1e-4 and rt_err <= 1e-5
            and np.isfinite(mv_wave).all() and np.isfinite(copy_wave).all()
            and mv_wave.shape == (1, mels[0].shape[1] * 256)):
        raise AssertionError("Vocos checks failed")
    del pipe, voc, mv
    torch.cuda.empty_cache()


# ---- the adversarial recipes and Tacotron2 training --------------------------

def timed_steps(make_step, times: list, metas: list, batches: list):
    """A stand-in for a CLI's make-step function: each step it makes is
    synchronized and timed on the host clock, its meta and batch kept."""
    def make(**kw):
        step = make_step(**kw)

        def run(state, batch, seed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta = step(state, batch, seed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metas.append({k: float(v) for k, v in meta.items()})
            batches.append(batch)
            return meta
        return run
    return make


def _finite(metas: list, keys) -> None:
    bad = [(i, k, m.get(k)) for i, m in enumerate(metas) for k in keys
           if not math.isfinite(m.get(k, math.nan))]
    if bad:
        raise AssertionError(f"non-finite or missing training terms: {bad}")


def _rate(times: list) -> tuple[float, float]:
    """Steps/s and ms a step over the steps after the first."""
    steady = times[1:]
    return len(steady) / sum(steady), sum(steady) / len(steady) * 1e3


def _moved_critic(state, seed: int) -> None:
    """Every critic parameter and iteration vector moved from its seeded
    init."""
    from tts_arabic_torch.train import gan, steps
    init = gan.PatchDiscriminator(steps.CRITIC_CNUM)
    u0 = gan.init_critic(init, seed)
    still = _unmoved(state.critic, init) + [
        k for k, u in state.spectral.items() if torch.equal(u.cpu(), u0[k])]
    if still:
        raise AssertionError(f"critic entries that did not move: {still}")


def _restored(trainer, config_path, make_model, adv: bool) -> int:
    """A fresh model (and critic) restored from the run's checkpoint:
    every model entry, the optimizers' moments, the critic and its vectors
    equal the trained ones; returns the restored step."""
    from tts_arabic_torch.runtime.config import get_config
    from tts_arabic_torch.train import steps
    from tts_arabic_torch.train.trainer import Trainer
    model = make_model().to("cuda")
    state = steps.TrainState(model, steps.make_optimizer(model))
    if adv:
        steps.add_critic(state, get_config(config_path), 7, "cuda")
    fresh = Trainer(None, state, log_dir=trainer.ckpt.directory / "restore",
                    checkpoint_dir=trainer.ckpt.directory, device="cuda")
    step = fresh.restore()
    fresh.close()
    old = trainer.state
    pairs = [("model", old.model.state_dict(), model.state_dict())]
    pairs.append(("optim", {str(k): v["exp_avg"] for k, v in
                            old.optimizer.state_dict()["state"].items()},
                  {str(k): v["exp_avg"] for k, v in
                   state.optimizer.state_dict()["state"].items()}))
    if adv:
        pairs += [("model_d", old.critic.state_dict(),
                   state.critic.state_dict()),
                  ("spectral_d", old.spectral, state.spectral),
                  ("optim_d",
                   {str(k): v["exp_avg_sq"] for k, v in
                    old.d_optimizer.state_dict()["state"].items()},
                   {str(k): v["exp_avg_sq"] for k, v in
                    state.d_optimizer.state_dict()["state"].items()})]
    differ = [f"{what}.{k}" for what, a, b in pairs for k in a
              if k not in b or not torch.equal(a[k], b[k])]
    if step != old.step or differ:
        raise AssertionError(f"checkpoint restored step {step} (trained "
                             f"{old.step}), entries that differ: {differ}")
    return step


def _profile_line(label: str, got, smi: str, extra=None) -> dict:
    """Logs a `profiled` result; `extra(by_name, busy)` adds to the
    line."""
    if got is None:
        log(f"{label} under torch.profiler: no device events recorded, "
            f"breakdown not measured | {smi}")
        return {}
    wall, by_name, busy, n_ops = got
    dev_ms = sum(by_name.values())
    extra = "" if extra is None else extra(by_name, busy)
    log(f"{label} under torch.profiler: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy:.1f} ms (idle {100 * (1 - busy / 1e3 / wall):.1f}% of "
        f"the wall), {n_ops} device ops summing {dev_ms:.1f} ms{extra} | "
        f"top: " + "; ".join(f"{n} {v:.2f} ms"
                             for n, v in by_name.most_common(8))
        + f" | {smi}")
    return dict(wall=wall, by_name=by_name, busy=busy, dev_ms=dev_ms)


def critic_alone_ms(state, batch: dict) -> float:
    """The critic's device work in one adversarial step, replayed alone at
    the step's shapes on a copy of the critic (CUDA events): its update
    (the real and the fake pass, backward, clip, AdamW) and the
    generator's pass through it (forward, backward to its input)."""
    from tts_arabic_torch.train import steps
    st = steps.TrainState(None, None, critic=copy.deepcopy(state.critic),
                          spectral=dict(state.spectral))
    st.d_optimizer = steps.make_optimizer(st.critic, 1e-4)
    b = steps.batch_to_device(batch, "cuda")
    fake = b["mel_tgt"] + 0.1       # stands in for the generator's mel
    c = steps._Critic(st, batch, "cuda", 0, None)

    def run():
        c.update(b["mel_tgt"], fake)
        x = fake.detach().requires_grad_()
        c.generator_terms(x, 0.0, {}, 3.0, 1.0).backward()
    return cuda_ms(run)


def _rows(batch: dict, n: int) -> dict:
    return {k: np.asarray(v)[:n] for k, v in batch.items()}


def _card_vs_cpu(make_state, make_step, batch: dict, label: str,
                 stats: bool, smi: str) -> None:
    """One f32 step (TF32 off) from the same weights, batch, seed and
    chunks on the card and on the CPU: loss terms within STEP_LOSS_TOL
    relative, gradients (after the clip) within STEP_GRAD_TOL of their
    norm, the critic's vectors within 1e-6, BatchNorm's running statistics
    within 1e-5."""
    set_tf32(False)
    precision = tf32_state()
    runs = {}
    for dev in ("cpu", "cuda"):
        state = make_state(dev)
        t0 = time.perf_counter()
        meta = make_step(device=dev)(state, batch, 0)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grads = {n: p.grad.detach().cpu() for n, p in
                 state.model.named_parameters() if p.grad is not None}
        extra = {f"u.{k}": u.cpu() for k, u in (state.spectral or {}).items()}
        if stats:
            extra.update({k: v.cpu() for k, v in
                          state.model.state_dict().items() if "running" in k})
        runs[dev] = ({k: float(v) for k, v in meta.items()}, grads, extra,
                     secs)
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's defaults
    (m_c, g_c, x_c, s_c), (m_g, g_g, x_g, s_g) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(m_g[k] - v) / max(abs(v), 1e-12)
                   for k, v in m_c.items())
    diff = math.sqrt(sum(float((g_g[n] - g).pow(2).sum())
                         for n, g in g_c.items()))
    norm = math.sqrt(sum(float(g.pow(2).sum()) for g in g_c.values()))
    u_err = max([float((x_g[k] - v).abs().max()) for k, v in x_c.items()
                 if k.startswith("u.")] or [0.0])
    s_err = max([float((x_g[k] - v).abs().max()) for k, v in x_c.items()
                 if "running" in k] or [0.0])
    log(f"    {label}: card vs CPU, one f32 step ({precision} on the "
        f"card), batch {tuple(np.asarray(batch['mel_tgt']).shape)}: loss "
        f"{m_g['loss']!r} vs {m_c['loss']!r}, max relative error of the "
        f"{len(m_c)} terms {loss_err:.2e} (<= {STEP_LOSS_TOL:.0e}) | "
        f"|g_card - g_cpu| {diff:.3e} of |g| {norm:.3e} (<= "
        f"{STEP_GRAD_TOL:.0e}) over {len(g_c)} tensors | vectors "
        f"{u_err:.2e} (<= 1e-6) | running statistics {s_err:.2e} (<= 1e-5)"
        f" | card {s_g * 1e3:.1f} ms, CPU {s_c * 1e3:.1f} ms | {smi}")
    if (m_c.keys() != m_g.keys() or g_c.keys() != g_g.keys()
            or loss_err > STEP_LOSS_TOL or not diff <= STEP_GRAD_TOL * norm
            or u_err > 1e-6 or s_err > 1e-5):
        raise AssertionError(f"{label}: the card's step differs from the "
                             "CPU's")


def phase_adversarial(root: pathlib.Path, smi: str) -> dict:
    """Phase 17: `train_fastpitch --adv` (see the module docstring)."""
    import dataclasses

    from tts_arabic_torch.apps import train_fastpitch
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.runtime.config import get_config
    from tts_arabic_torch.train import gan, steps
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    config_path = corpus_config(root, "nawar_fp_adv.yaml")
    train, val = training_batches(config_path)
    times, metas, batches, mas_shapes = [], [], [], []
    fused = mas_ops.mas_fused

    def recorded(log_attn, in_lens, out_lens):
        mas_shapes.append(tuple(log_attn.shape))
        return fused(log_attn, in_lens, out_lens)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_fastpitch, "make_fastpitch_train_step",
                           timed_steps(steps.make_fastpitch_train_step,
                                       times, metas, batches)), \
            mock.patch.object(mas_ops, "mas_fused", recorded):
        rb.reset_launches()
        mas_ops.reset_launches()
        trainer = train_fastpitch.main([
            "--config", str(config_path), "--adv", "--epochs", "1",
            "--log-every", "1", "--device", "cuda", "--no-figures"])
        torch.cuda.synchronize()
        launches = {**rb.LAUNCHES, **mas_ops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, (m, t) in enumerate(zip(metas, times)):
        log(f"    step {i + 1}: loss {m['loss']:.4f} (critic {m['loss_d']:.4f}"
            f", score {m['score']:.4f}, fmatch {m['fmatch']:.4f}), "
            f"{t * 1e3:.1f} ms")
    n_steps = len(train)
    if len(times) != n_steps or trainer.state.step != n_steps:
        raise AssertionError(f"{len(times)} adversarial steps, state at "
                             f"{trainer.state.step}, expected {n_steps}")
    _finite(metas, ("loss", "loss_d", "score", "fmatch", "grad_norm"))
    want = [tuple(b["attn_prior"].shape) for b in train + val]
    if mas_shapes != want or launches["mas"] != len(want):
        raise AssertionError(f"MAS calls at {mas_shapes}, {launches['mas']} "
                             f"launches; expected {want}")
    if sum(rb.LAUNCHES.values()):
        raise AssertionError(f"ResBlock launches in training: {rb.LAUNCHES}")
    # MAS at the run's shapes and lengths: bit-equal, and its time
    gen = torch.Generator(device="cuda").manual_seed(1)
    mas_ms = max_err = 0.0
    for i, batch in enumerate(train + val):
        inputs = _mas_inputs(tuple(batch["attn_prior"].shape), gen,
                             batch["token_lens"], batch["mel_lens"])
        max_err = max(max_err, _mas_check(inputs, f"adversarial run {i}"))
        mas_ms += cuda_ms(lambda: mas_ops.mas_fused(*inputs))
    seed = trainer.seed
    _moved_critic(trainer.state, seed + 1)
    still = _unmoved(trainer.state.model,
                     init_weights(FastPitch(FastPitchConfig()), seed))
    if any(not n.startswith("attention.attn_proj") for n in still):
        raise AssertionError(f"parameters that did not move: {still}")
    rows = [json.loads(ln) for ln in (pathlib.Path(
        trainer.logger.log_dir) / "metrics.jsonl").read_text().splitlines()]
    val_loss = [r["val/loss"] for r in rows if "val/loss" in r]
    if len(val_loss) != 1 or not math.isfinite(val_loss[0]):
        raise AssertionError(f"validation losses {val_loss}")
    restored = _restored(trainer, config_path, FastPitch, adv=True)
    rate, step_ms = _rate(times)
    cfg = get_config(config_path)
    log(f"[17 adversarial fastpitch] train_fastpitch.main --adv, "
        f"FastPitchConfig() + PatchDiscriminator({steps.CRITIC_CNUM}), "
        f"nawar_fp_adv.yaml recipe (gan {cfg.gan_loss_weight}, feat "
        f"{cfg.feat_loss_weight}, betas ({cfg.g_beta1}, {cfg.g_beta2})), f32,"
        f" {tf32_state()}: {n_steps} steps of batch "
        f"{sorted({s[0] for s in want[:n_steps]})} (T_mel <= "
        f"{max(s[1] for s in want[:n_steps])}) + {len(val)} validation "
        f"batch(es), val loss {val_loss[0]:.4f} | steps 2-{n_steps}: "
        f"{rate:.2f} steps/s, {step_ms:.1f} ms a step | MAS: "
        f"{launches['mas']} launches, bit-equal to the plain version at the "
        f"run's {len(want)} shapes (max err {max_err}), {mas_ms:.3f} ms for "
        f"them = {mas_ms / (len(want)) :.3f} ms a launch | critic and its "
        f"vectors moved | checkpoint step {restored} restores model, optim,"
        f" model_d, optim_d, spectral_d equal | peak memory {peak_gb:.2f} GB"
        f" | {smi}")

    # one more step at the first batch, under the profiler
    state, batch = trainer.state, batches[0]
    step = steps.make_fastpitch_train_step(device="cuda")
    step(state, batch, 1)
    got = profiled(lambda: step(state, batch, 2))
    critic_ms = critic_alone_ms(state, batch)

    def shares(by_name, busy):
        mas = sum(v for n, v in by_name.items() if "mas_kernel" in n)
        return (f" | MAS kernel {mas:.4f} ms = "
                f"{100 * mas / sum(by_name.values()):.3f}% of the device "
                f"time | the critic's work replayed alone (CUDA events) "
                f"{critic_ms:.2f} ms = {100 * critic_ms / busy:.1f}% of the "
                f"step's device busy time")
    prof = _profile_line(
        f"[17 profile] one steady adversarial step at "
        f"{tuple(batch['attn_prior'].shape)}", got, smi, shares)

    # card vs CPU, full width, dropouts off, two rows of the first batch
    nodrop = dataclasses.replace(FastPitchConfig(), **{
        f.name: 0.0 for f in dataclasses.fields(FastPitchConfig)
        if "drop" in f.name})
    base = init_weights(FastPitch(nodrop), 0)
    critic = gan.PatchDiscriminator(steps.CRITIC_CNUM)
    spec = gan.init_critic(critic, 1)

    def make_state(dev):
        model, d = copy.deepcopy(base).to(dev), copy.deepcopy(critic).to(dev)
        return steps.TrainState(
            model, steps.make_optimizer(model), critic=d,
            d_optimizer=steps.make_optimizer(d),
            spectral={k: u.to(dev) for k, u in spec.items()})
    _card_vs_cpu(make_state, steps.make_fastpitch_train_step,
                 _rows(train[0], 2), "[17 check] FastPitch --adv", False, smi)
    del trainer, state
    torch.cuda.empty_cache()
    return dict(launches=launches["mas"], mas_ms=mas_ms, rate=rate,
                step_ms=step_ms, critic_ms=critic_ms, profile=prof)


def t2_short_batch(config_path) -> dict:
    """The corpus's two shortest utterances, their mels cut to
    T2_SHORT_FRAMES frames, collated for Tacotron2."""
    from tts_arabic_torch.data import ArabDataset, collate_tacotron
    from tts_arabic_torch.runtime.config import get_config
    cfg = get_config(config_path)
    ds = ArabDataset(cfg.train_labels, cfg.train_wavs_path,
                     label_pattern=cfg.label_pattern)
    items = sorted((ds[i] for i in range(len(ds))),
                   key=lambda it: it[1].shape[1])[:2]
    return collate_tacotron([(t, m[:, :T2_SHORT_FRAMES]) for t, m in items])


def _t2_run(train_tacotron, config_path, flags: list) -> tuple:
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.train import steps
    times, metas, batches = [], [], []
    with mock.patch.object(train_tacotron, "make_tacotron_train_step",
                           timed_steps(steps.make_tacotron_train_step,
                                       times, metas, batches)):
        rb.reset_launches()
        mas_ops.reset_launches()
        trainer = train_tacotron.main([
            "--config", str(config_path), "--max-steps", str(T2_STEPS),
            "--log-every", "1", "--device", "cuda", "--no-figures"] + flags)
        torch.cuda.synchronize()
        launched = sum(rb.LAUNCHES.values()) + mas_ops.LAUNCHES["mas"]
    if launched:
        raise AssertionError(f"Tacotron2 training launched {launched} "
                             "ResBlock or MAS kernels")
    if len(times) != T2_STEPS or trainer.state.step != T2_STEPS:
        raise AssertionError(f"{len(times)} Tacotron2 steps, expected "
                             f"{T2_STEPS}")
    return trainer, times, metas, batches


def phase_tacotron_training(root: pathlib.Path, smi: str) -> dict:
    """Phase 18: `train_tacotron` and `train_tacotron --adv` (see the
    module docstring)."""
    import dataclasses

    from tts_arabic_torch.apps import train_tacotron
    from tts_arabic_torch.models import tacotron2 as t2
    from tts_arabic_torch.train import steps
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    mse_path = corpus_config(root, "nawar_tc2.yaml")
    adv_path = corpus_config(root, "nawar_tc2_adv.yaml", test_labels="")
    out = {}
    for label, path, flags in (("mse", mse_path, []),
                               ("adv", adv_path, ["--adv"])):
        trainer, times, metas, batches = _t2_run(train_tacotron, path, flags)
        keys = ["loss", "mel_loss", "post_mel_loss", "gate_loss",
                "grad_norm"] + (["loss_d", "score", "fmatch"] if flags else [])
        _finite(metas, keys)
        for i, (m, t) in enumerate(zip(metas, times)):
            log(f"    {label} step {i + 1}: loss {m['loss']:.4f}, grad norm "
                f"{m['grad_norm']:.3f}" + (f", critic {m['loss_d']:.4f}, "
                                           f"score {m['score']:.4f}"
                                           if flags else "")
                + f", {t * 1e3:.1f} ms")
        model = trainer.state.model
        init = t2.init_tacotron2(t2.Tacotron2(model.config), trainer.seed)
        stats = [k for k, v in init.state_dict().items() if "running" in k
                 and torch.equal(v, model.state_dict()[k].cpu())]
        if stats:
            raise AssertionError(f"BatchNorm statistics that did not move: "
                                 f"{stats}")
        still = _unmoved(model, init)
        if still:
            raise AssertionError(f"parameters that did not move: {still}")
        if flags:
            _moved_critic(trainer.state, trainer.seed + 1)
        rows = [json.loads(ln) for ln in (pathlib.Path(
            trainer.logger.log_dir) / "metrics.jsonl").read_text(
        ).splitlines()]
        val_loss = [r["val/loss"] for r in rows if "val/loss" in r]
        if len(val_loss) != (0 if flags else 1) or not all(
                math.isfinite(v) for v in val_loss):
            raise AssertionError(f"{label}: validation losses {val_loss}")
        restored = _restored(trainer, path,
                             lambda: t2.Tacotron2(model.config), bool(flags))
        rate, step_ms = _rate(times)
        shapes = [tuple(np.asarray(b["mel_tgt"]).shape[:2]) for b in batches]
        c = model.config
        log(f"[18 tacotron2 training{' --adv' if flags else ''}] "
            f"train_tacotron.main{' --adv' if flags else ''}, "
            f"Tacotron2Config() (encoder {c.encoder_embedding_dim}, LSTMs "
            f"{c.attention_rnn_dim}/{c.decoder_rnn_dim}, postnet "
            f"{c.postnet_n_convolutions} x {c.postnet_embedding_dim})"
            f"{' + PatchDiscriminator(32)' if flags else ''}, "
            f"{pathlib.Path(path).name.replace('_smoke', '')} recipe (clip "
            f"{trainer.state.optimizer.grad_clip}), f32, {tf32_state()}: "
            f"{T2_STEPS} steps at [B, T_mel] {shapes}"
            + (f" + validation, val loss {val_loss[0]:.4f}" if val_loss
               else "") + f" | steps 2-{T2_STEPS}: {rate:.3f} steps/s, "
            f"{step_ms:.1f} ms a step | BatchNorm statistics moved | "
            f"checkpoint step {restored} restores model, optim, "
            f"batch_stats{', model_d, optim_d, spectral_d' if flags else ''}"
            f" equal | {smi}")
        out[label] = dict(rate=rate, step_ms=step_ms)
        if not flags:
            state, batch = trainer.state, batches[0]
            step = steps.make_tacotron_train_step(device="cuda")
            got = profiled(lambda: step(state, batch, 1))
            out["profile"] = _profile_line(
                f"[18 profile] one steady MSE step at {shapes[0]}", got, smi)
        del trainer
        torch.cuda.empty_cache()

    # card vs CPU at full width on a short batch, dropouts off
    nodrop = t2.Tacotron2Config(prenet_dropout=0.0, attention_dropout=0.0,
                                decoder_dropout=0.0)
    base = t2.init_tacotron2(t2.Tacotron2(nodrop), 0)
    from tts_arabic_torch.train import gan
    critic = gan.PatchDiscriminator(steps.CRITIC_CNUM)
    spec = gan.init_critic(critic, 1)

    def make_state(dev):
        model, d = copy.deepcopy(base).to(dev), copy.deepcopy(critic).to(dev)
        return steps.TrainState(
            model, steps.make_optimizer(model, 1e-3, grad_clip=1.0),
            critic=d, d_optimizer=steps.make_optimizer(d),
            spectral={k: u.to(dev) for k, u in spec.items()})
    with mock.patch.object(t2.Tacotron2, "_dropout",
                           lambda self, x, rate, gen: x):
        _card_vs_cpu(make_state, steps.make_tacotron_train_step,
                     t2_short_batch(mse_path), "[18 check] Tacotron2 --adv",
                     True, smi)
    return out


# ---- HiFi-GAN vocoder training -----------------------------------------------

def voc_kernel_checks(frames: int, batches: list, smi: str) -> dict:
    """The f32 ResBlock kernels at vocoder training's shapes (each stage of
    a `frames`-frame segment, k 3/7/11, at each batch size of the run):
    kernel vs `resblock1_plain` (TF32 off), kernel ms, plain ms (cuDNN
    f32) and bound (3xTF32's, and the CUDA cores'); then
    `ResBlock1Function`'s gradients against autograd of the plain version
    at the largest batch (GRAD_TOL of their norm). Returns per variant
    {batch: (ms, plain_ms, bound_ms, t_ops, t_bytes, cuda_core_ms)} summed
    over one generator forward's launches, and the largest errors."""
    from tts_arabic_torch.ops import resblock as rb
    gen = torch.Generator(device="cuda").manual_seed(19)
    set_tf32(False)
    per = {}
    max_abs = grad_rel = 0.0
    B = max(batches)
    log(f"[19 kernel checks] f32 (3xTF32 tensor cores), TF32 off, training "
        f"shapes: {frames} frames a segment, batch "
        f"{' and '.join(map(str, batches))}; err = max|kernel - plain| / "
        f"max|plain|; grad = max over x, w1, b1, w2, b2 of |g_function - "
        f"g_plain| / |g_plain| at batch {B}; bound_ms at 3xTF32's "
        f"{RESBLOCK_F32_FLOPS / 1e12:.0f} TFLOP/s, cc_ms at the CUDA cores' "
        f"{PEAK_FLOPS[torch.float32] / 1e12:.0f}")
    log(f"    {'variant':17} {'C':>4} {'k':>3} {'B':>3} {'T':>6} {'err':>9} "
        f"{'grad':>9} {'ms':>8} {'plain_ms':>9} {'bound_ms':>9} "
        f"{'cc_ms':>8}")
    for C, t_per in STAGE_T.items():
        T = t_per * frames
        name = rb.variant(C)
        for k in KERNEL_SIZES:
            for b in sorted(batches, reverse=True):
                args, err, rel = _rel_err(rb, name, C, k, T, torch.float32,
                                          gen, batch=b)
                max_abs = max(max_abs, err)
                ms = cuda_ms(lambda: rb.resblock1(*args, k, DILATIONS))
                plain_ms = cuda_ms(lambda: rb.resblock1_plain(
                    *args, k, DILATIONS))
                t_ops, t_bytes = bound(C, k, T, torch.float32, b)
                g_msg = ""
                if b == B:
                    g = _function_grad_rel(rb, args, k)
                    grad_rel = max(grad_rel, g)
                    g_msg = f"{g:.2e}"
                cc = cuda_core_ms(C, k, T, b)
                row = per.setdefault(name, {}).setdefault(b, [0.0] * 6)
                for i, v in enumerate((ms, plain_ms, max(t_ops, t_bytes),
                                       t_ops, t_bytes, cc)):
                    row[i] += v
                log(f"    {name:17} {C:>4} {k:>3} {b:>3} {T:>6} {rel:>9.2e} "
                    f"{g_msg:>9} {ms:>8.3f} {plain_ms:>9.3f} "
                    f"{max(t_ops, t_bytes):>9.3f} {cc:>8.3f}")
                del args
    log(f"    one forward's ResBlocks, batch {B}: " + "; ".join(
        f"{n} {v[B][0]:.2f} ms (plain {v[B][1]:.2f}, bound {v[B][2]:.2f}, "
        f"CUDA-core bound {v[B][5]:.2f})" for n, v in per.items())
        + f" | {smi}")
    if not grad_rel <= GRAD_TOL:
        raise AssertionError(f"ResBlock1Function gradients {grad_rel:.2e} "
                             f"> {GRAD_TOL}")
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's defaults
    torch.cuda.empty_cache()
    return dict(per=per, max_abs_err=max_abs, grad_rel=grad_rel)


def _function_grad_rel(rb, args, k) -> float:
    """`ResBlock1Function` (kernel forward, plain recompute) against
    autograd of `resblock1_plain`: the largest |g_fn - g_plain| / |g_plain|
    over the five inputs, for sum(y * r)."""
    r = torch.randn(args[0].shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    grads = []
    for fn in (rb.ResBlock1Function.apply, rb.resblock1_plain):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        (fn(*leaves, k, DILATIONS) * r).sum().backward()
        grads.append([t.grad for t in leaves])
    return max(float((a - b).norm() / b.norm())
               for a, b in zip(*grads))


def write_reference_vocoder(path: pathlib.Path, seed: int):
    """A seeded HiFi-GAN V1 written as the reference's `.pth` (conv weights
    as weight_g / weight_v pairs under "generator"); returns the port's
    generator with those weights."""
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.vocoder.hifigan import Generator
    gen = init_weights(Generator(), seed)
    sd = {}
    for k, v in gen.state_dict().items():
        if k.endswith(".weight"):
            norm = torch.linalg.vector_norm(v.reshape(v.shape[0], -1),
                                            dim=1)
            sd[k[:-6] + "weight_g"] = norm.reshape(-1, 1, 1)
            sd[k[:-6] + "weight_v"] = v
        else:
            sd[k] = v
    torch.save({"generator": sd}, path)
    return gen


def _voc_restored(trainer, width: float) -> int:
    """A fresh vocoder state restored from the run's checkpoint: model,
    optim, model_d and optim_d equal the trained ones; returns the
    restored step."""
    from tts_arabic_torch.train import vocoder as voc
    from tts_arabic_torch.train.trainer import Trainer
    from tts_arabic_torch.vocoder.discriminators import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator)
    from tts_arabic_torch.vocoder.hifigan import Generator
    old = trainer.state
    state = voc.init_vocoder_state(
        Generator(old.model.config),
        MultiPeriodDiscriminator(old.critic["mpd"].periods, width),
        MultiScaleDiscriminator(old.critic["msd"].n_scales, width), seed=7,
        device="cuda")
    fresh = Trainer(None, state, log_dir=trainer.ckpt.directory / "restore",
                    checkpoint_dir=trainer.ckpt.directory, device="cuda")
    step = fresh.restore()
    fresh.close()

    def moments(opt):
        return {f"{i}.{k}": v for i, s in opt.state_dict()["state"].items()
                for k, v in s.items()}
    pairs = [("model", old.model.state_dict(), state.model.state_dict()),
             ("model_d", old.critic.state_dict(),
              state.critic.state_dict()),
             ("optim", moments(old.optimizer), moments(state.optimizer)),
             ("optim_d", moments(old.d_optimizer),
              moments(state.d_optimizer))]
    differ = [f"{what}.{k}" for what, a, b in pairs for k in a
              if k not in b or not torch.equal(a[k], b[k])]
    if step != old.step or differ:
        raise AssertionError(f"checkpoint restored step {step} (trained "
                             f"{old.step}), entries that differ: {differ}")
    return step


def _voc_card_vs_cpu(wave: np.ndarray, periods, smi: str) -> None:
    """One vocoder step from the same weights and batch, at full width: in
    f32 on the card (TF32 off) and on the CPU, and in float64 on the CPU
    (plain ResBlocks), the exact step's arithmetic. Loss terms: the card
    within STEP_LOSS_TOL (relative) of both. Gradients (after the clip,
    the generator's and the discriminators'): the CPU's f32 step is
    itself about 2e-4 of their norm from the float64 step at this width
    (mostly the last stage's bias gradients, sums over every sample of
    terms that cancel), so two f32 steps cannot meet STEP_GRAD_TOL
    against each other; the card is held to the float64 step instead,
    within STEP_GRAD_TOL or F32_SPREAD times the CPU f32 step's own
    distance from it, whichever is larger."""
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.train import vocoder as voc
    from tts_arabic_torch.vocoder import hifigan
    from tts_arabic_torch.vocoder.discriminators import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator)
    set_tf32(False)
    base = init_weights(hifigan.Generator(), 0)
    critic = torch.nn.ModuleDict({
        "mpd": init_weights(MultiPeriodDiscriminator(periods), 1),
        "msd": init_weights(MultiScaleDiscriminator(), 2)})
    runs = {}
    for label, dev, dtype in (("card", "cuda", torch.float32),
                              ("cpu", "cpu", torch.float32),
                              ("f64", "cpu", torch.float64)):
        st = voc.init_vocoder_state(
            hifigan.Generator(), MultiPeriodDiscriminator(periods),
            MultiScaleDiscriminator(), device=dev)
        st.model.load_state_dict(base.state_dict())
        st.critic.load_state_dict(critic.state_dict())
        st.model.to(dtype)
        st.critic.to(dtype)
        plain = (mock.patch.object(hifigan, "resblock1", rb.resblock1_plain)
                 if dtype == torch.float64 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with plain:
            meta = voc.make_hifigan_train_step(device=dev)(
                st, {"wave": torch.tensor(wave, dtype=dtype)}, 0)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grads = {f"g.{n}": p.grad.detach().double().cpu()
                 for n, p in st.model.named_parameters()}
        grads.update({f"d.{n}": p.grad.detach().double().cpu()
                      for n, p in st.critic.named_parameters()})
        runs[label] = ({k: float(v) for k, v in meta.items()}, grads, secs)
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False   # PyTorch's defaults

    def dist(a, b, prefix=""):
        keys = [k for k in b if k.startswith(prefix)]
        d = math.sqrt(sum(float((a[k] - b[k]).pow(2).sum()) for k in keys))
        return d / math.sqrt(sum(float(b[k].pow(2).sum()) for k in keys))
    (m_g, g_g, s_g), (m_c, g_c, s_c), (m_x, g_x, s_x) = (
        runs["card"], runs["cpu"], runs["f64"])
    term = max(max(abs(m_g[k] - v) / abs(v) for k, v in m.items())
               for m in (m_c, m_x))
    card, cpu = dist(g_g, g_x), dist(g_c, g_x)
    gate = max(STEP_GRAD_TOL, F32_SPREAD * cpu)
    norm = math.sqrt(sum(float(g.pow(2).sum()) for g in g_x.values()))
    log(f"    [19 check] HiFi-GAN step, full width, batch {wave.shape}, "
        f"TF32 off: loss {m_g['loss']!r} (card f32) vs {m_c['loss']!r} "
        f"(CPU f32) vs {m_x['loss']!r} (CPU f64), max relative error of the "
        f"{len(m_x)} terms {term:.2e} (<= {STEP_LOSS_TOL:.0e}) | gradients "
        f"from the f64 step, of its norm {norm:.3e}: card {card:.3e} "
        f"(generator {dist(g_g, g_x, 'g.'):.3e}, "
        f"discriminators {dist(g_g, g_x, 'd.'):.3e}) <= max("
        f"{STEP_GRAD_TOL:.0e}, {F32_SPREAD} x CPU f32's) = {gate:.3e}; CPU "
        f"f32 {cpu:.3e} (generator {dist(g_c, g_x, 'g.'):.3e}, "
        f"discriminators {dist(g_c, g_x, 'd.'):.3e}); card vs "
        f"CPU f32 {dist(g_g, g_c):.3e} | card {s_g * 1e3:.1f} ms, CPU "
        f"{s_c * 1e3:.1f} ms, f64 {s_x * 1e3:.1f} ms | {smi}")
    if (m_g.keys() != m_x.keys() or g_g.keys() != g_x.keys()
            or term > STEP_LOSS_TOL or not card <= gate):
        raise AssertionError("[19 check] the card's vocoder step differs "
                             "from the CPU's")


def phase_vocoder_training(root: pathlib.Path, smi: str) -> dict:
    """Phase 19: `train_vocoder` at full width (see the module
    docstring)."""
    from tts_arabic_torch.apps import train_vocoder
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.runtime.config import get_config
    from tts_arabic_torch.train import vocoder as voc
    from tts_arabic_torch.vocoder.discriminators import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator)
    from tts_arabic_torch.vocoder.hifigan import generator_flops_per_frame
    t0 = time.perf_counter()
    warm = write_reference_vocoder(root / "hifigan_seeded.pth", 3)
    config_path = corpus_config(
        root, "hifigan_ft.yaml",
        vocoder_state_path=str(root / "hifigan_seeded.pth"))
    cfg = get_config(config_path)
    seg, bs = cfg.segment_length, cfg.batch_size
    frames = seg // HOP
    n_train = len((root / "train.txt").read_text().splitlines())
    n_val = len((root / "test.txt").read_text().splitlines())
    train_b = [min(bs, n_train - i) for i in range(0, n_train, bs)]
    val_b = [min(bs, n_val - i) for i in range(0, n_val, bs)]
    checks = voc_kernel_checks(frames, sorted(set(train_b + val_b)), smi)

    torch.backends.cudnn.allow_tf32 = True          # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    times, metas, batches, first = [], [], [], {}
    timed = timed_steps(voc.make_hifigan_train_step, times, metas, batches)

    def make(**kw):
        run = timed(**kw)

        def step(state, batch, seed):
            if not first:   # the weights the first update starts from
                first.update({k: v.detach().clone() for k, v in
                              state.model.state_dict().items()})
            return run(state, batch, seed)
        return step
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_vocoder, "make_hifigan_train_step", make):
        rb.reset_launches()
        mas_ops.reset_launches()
        trainer = train_vocoder.main([
            "--config", str(config_path), "--epochs", "1", "--log-every",
            "1", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = {**rb.LAUNCHES, **mas_ops.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    keys = ("loss", "loss_d", "d_mpd_loss", "d_msd_loss", "mel_loss",
            "gen_adv_loss", "feat_loss")
    for i, (m, t) in enumerate(zip(metas, times)):
        log(f"    step {i + 1}: "
            + ", ".join(f"{k} {m[k]:.4f}" for k in keys)
            + f", {t * 1e3:.1f} ms")
    n_steps, n_vb = len(train_b), len(val_b)
    if len(times) != n_steps or trainer.state.step != n_steps:
        raise AssertionError(f"{len(times)} vocoder steps, state at "
                             f"{trainer.state.step}, expected {n_steps}")
    if [len(b["wave"]) for b in batches] != train_b:
        raise AssertionError(f"batches of "
                             f"{[len(b['wave']) for b in batches]}, "
                             f"expected {train_b}")
    _finite(metas, keys)
    want = {"resblock1_wide": 54 * n_steps + 27 * n_vb,
            "resblock1_narrow": 6 * n_steps + 3 * n_vb, "mas": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} (54 "
                             "wide + 6 narrow a step, 27 + 3 a validation "
                             "batch)")
    differ = [k for k, v in warm.state_dict().items()
              if not torch.allclose(first[k].cpu(), v, rtol=1e-6,
                                    atol=1e-7)]
    if differ:
        raise AssertionError(f"the warm start did not load: {differ}")
    state = trainer.state
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach(), first[n])]
    seed = trainer.seed
    periods = tuple(cfg.get("mpd_periods", (2, 3, 5, 7, 11)))
    width = cfg.get("disc_width", 1.0)
    still += [f"mpd.{n}" for n in _unmoved(state.critic["mpd"], init_weights(
        MultiPeriodDiscriminator(periods, width), seed + 1))]
    still += [f"msd.{n}" for n in _unmoved(state.critic["msd"], init_weights(
        MultiScaleDiscriminator(cfg.get("msd_scales", 3), width), seed + 2))]
    if still:
        raise AssertionError(f"parameters that did not move: {still}")
    rows = [json.loads(ln) for ln in (pathlib.Path(
        trainer.logger.log_dir) / "metrics.jsonl").read_text().splitlines()]
    val_loss = [r["val/loss"] for r in rows if "val/loss" in r]
    if len(val_loss) != 1 or not math.isfinite(val_loss[0]):
        raise AssertionError(f"validation losses {val_loss}")
    restored = _voc_restored(trainer, width)
    rate, step_ms = _rate(times)
    # a batch size the run has met before: no first-time cuDNN plans
    repeat = [t for i, t in enumerate(times) if train_b[i] in train_b[:i]]
    repeat_ms = sum(repeat) / len(repeat) * 1e3 if repeat else math.nan
    n_fwd = {b: 2 * train_b.count(b) + val_b.count(b)
             for b in set(train_b + val_b)}
    summed = {name: [sum(n_fwd[b] * v[b][i] for b in n_fwd)
                     for i in range(6)] for name, v in checks["per"].items()}
    gen_gflop = generator_flops_per_frame(state.model.config) * frames / 1e9
    log(f"[19 vocoder training] train_vocoder.main, HiFi-GAN V1 warm-started"
        f" from a seeded reference .pth + MPD {periods} + MSD "
        f"{state.critic['msd'].n_scales} scales at full width, hifigan_ft."
        f"yaml recipe (segment {seg}, mel x{cfg.mel_loss_weight}, betas "
        f"({cfg.g_beta1}, {cfg.g_beta2}), lr decay {cfg.lr_decay}), f32, "
        f"{tf32_state()}: {n_steps} steps of batch {train_b} + {n_vb} "
        f"validation batch(es) {val_b}, val loss {val_loss[0]:.4f} | steps "
        f"2-{n_steps}: {rate:.2f} steps/s, {step_ms:.1f} ms a step "
        f"({len(repeat)} at a batch size met before: {repeat_ms:.1f} ms a "
        f"step) | launches {launches} | ResBlock kernels over the run's "
        f"launches (phase 19 times): " + "; ".join(
            f"{n} {v[0]:.2f} ms (plain {v[1]:.2f}, bound {v[2]:.2f}, "
            f"CUDA-core bound {v[5]:.2f})" for n, v in summed.items())
        + f" | generator forward {gen_gflop * bs:.1f} GFLOP at batch {bs} | "
        f"every generator and discriminator parameter moved | checkpoint "
        f"step {restored} restores model, optim, model_d, optim_d equal | "
        f"peak memory {peak_gb:.2f} GB | {smi}")

    # one more step at the first batch, under the profiler
    step = voc.make_hifigan_train_step(device="cuda")
    batch = batches[0]
    step(state, batch, 0)
    got = profiled(lambda: step(state, batch, 0))

    def shares(by_name, busy):
        k_ms = sum(v for n, v in by_name.items() if "resblock1" in n)
        return (f" | ResBlock kernels {k_ms:.2f} ms = "
                f"{100 * k_ms / sum(by_name.values()):.1f}% of the device "
                f"time")
    prof = _profile_line(f"[19 profile] one steady step at batch "
                         f"{len(batch['wave'])}, segment {seg}", got, smi,
                         shares)
    del trainer, state, step
    torch.cuda.empty_cache()

    _voc_card_vs_cpu(np.asarray(batches[0]["wave"])[:2, :4096], periods,
                     smi)
    took = time.perf_counter() - t0
    log(f"[19] the phase: {took:.1f} s")
    return dict(launches=launches, summed=summed, rate=rate, step_ms=step_ms,
                repeat_ms=repeat_ms, profile=prof, checks=checks)


# ---- phase 20: AOT serving bundles and the offline apps ---------------------

BUNDLE_LSB = 8          # bundle vs live, int16 (JAX tests/test_apps.py:342)
T2_BUNDLE_STEPS = 768   # the Tacotron2 bundle's decode cap (JAX's default)


def _live_batches(prompts: list[str], tokenize) -> list[tuple]:
    """tts()'s batches of the prompts: the global length sort, BATCH rows
    each, and inside a batch the rows sorted by token count as the
    pipelines sort them. -> [(prompt indices in row order, padded token
    length)]."""
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    out = []
    for k in range(0, len(order), BATCH):
        idxs = order[k: k + BATCH]
        lens = np.asarray([tokenize(prompts[i]) for i in idxs])
        rows = [idxs[j] for j in np.argsort(-lens)]
        out.append((rows, -(-int(lens.max()) // 16) * 16))
    return out


def _pt2_bytes(out: pathlib.Path) -> int:
    return sum(p.stat().st_size for p in out.glob("*.pt2"))


def _lsb(got: list, ref: list) -> int:
    """max |got - ref| over waves of equal lengths (int16 LSB)."""
    worst = 0
    for g, r in zip(got, ref):
        if g.dtype != np.int16 or g.shape != r.shape:
            raise AssertionError(f"bundle wave {g.dtype} {g.shape}, live "
                                 f"{r.dtype} {r.shape}")
        worst = max(worst, int(np.abs(g.astype(np.int32)
                                      - r.astype(np.int32)).max()))
    return worst


def _serve(bundle, prompts: list[str], batches: list[tuple]) -> list:
    """The bundle's tts() of each live batch, its rows in the live order;
    the waves back in prompt order."""
    waves = [None] * len(prompts)
    for rows, _ in batches:
        for i, w in zip(rows, bundle.tts([prompts[i] for i in rows],
                                         denoise=0.005)):
            waves[i] = w
    return waves


def phase_fastpitch_bundle(smi: str, tmp: pathlib.Path) -> dict:
    """Phase 4's full-width bf16 FastPitch + HiFi-GAN V1 exported from a
    `states.ckpt` at batch 8 and the text and mel buckets the 16 prompts
    need, served by `ServingBundle` against the live `tts(out_int16=True)`
    of the same weights."""
    from tts_arabic_torch.apps import export_serving as es
    from tts_arabic_torch.eval import flops
    from tts_arabic_torch.infer.pipeline import _pick_mel_bucket
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.runtime.profiling import benchmark
    prompts = load_prompts(N_PROMPTS)
    pipe = make_pipe(torch.bfloat16)
    batches = _live_batches(prompts, lambda t: len(pipe.model.tokenize(t)))
    live = pipe.tts(prompts, batch_size=BATCH, denoise=0.005, out_int16=True)
    text_buckets = sorted({tb for _, tb in batches})
    # each live batch's mel bucket, from its longest row (the live path
    # vocodes in length groups; a wave program, the whole batch at it)
    buckets = [_pick_mel_bucket(max(len(live[i]) for i in rows)
                                // pipe.hop_length) for rows, _ in batches]
    mel_buckets = sorted(set(buckets))
    ckpt = save_checkpoint(pipe, tmp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = es.export_bundle(tmp / "fastpitch_bundle", str(ckpt),
                           batch_sizes=(BATCH,), text_buckets=text_buckets,
                           mel_buckets=mel_buckets, device="cuda")
    export_s = time.perf_counter() - t0
    bundle = es.ServingBundle(out)
    got = _serve(bundle, prompts, batches)         # loads the programs
    rb.reset_launches()
    got = _serve(bundle, prompts, batches)
    launches = dict(rb.LAUNCHES)
    want = {"resblock1_wide": 27 * len(batches),
            "resblock1_narrow": 3 * len(batches)}
    if launches != want:
        raise AssertionError(f"bundle launches {launches}, expected {want}: "
                             "27 wide + 3 narrow a wave-program call")
    lsb = _lsb(got, live)
    if lsb > BUNDLE_LSB:
        raise AssertionError(f"FastPitch bundle {lsb} LSB from the live "
                             f"path (> {BUNDLE_LSB})")
    audio_s = sum(w.size for w in live) / pipe.sample_rate
    t_bundle = benchmark(lambda: _serve(bundle, prompts, batches), iters=3)
    t_live = benchmark(lambda: pipe.tts(prompts, batch_size=BATCH,
                                        denoise=0.005, out_int16=True),
                       iters=3)
    cfg = pipe.model.config
    tbx = max(text_buckets)
    work = sum(BATCH * (flops.fastpitch_encode_flops(cfg, tb)
                        + flops.fastpitch_decode_flops(cfg, tbx, mb)
                        + flops.hifigan_flops(mb, pipe.vocoder_config))
               for (_, tb), mb in zip(batches, buckets))
    prof = profiled(lambda: _serve(bundle, prompts, batches))
    peak = flops.chip_peak_flops(0, "bf16")
    busy = prof[2] if prof else float("nan")
    mfu = work / (busy / 1e3) / peak if prof and peak else float("nan")
    log(f"[20 fastpitch bundle] batch {BATCH}, text buckets "
        f"{text_buckets}, mel buckets {mel_buckets}: export "
        f"{export_s:.1f} s, {len(list(out.glob('*.pt2')))} programs, "
        f"{_pt2_bytes(out)} bytes | ServingBundle vs live tts(out_int16="
        f"True): max {lsb} LSB (gate {BUNDLE_LSB}) | launches {launches} | "
        f"real time: bundle {audio_s / t_bundle.median_s:.1f}x ({t_bundle}),"
        f" live {audio_s / t_live.median_s:.1f}x ({t_live}) | one serving "
        f"of the 16 prompts under torch.profiler: device busy {busy:.2f} ms, "
        f"{work / 1e9:.1f} GFLOP (eval.flops) = MFU {100 * mfu:.2f}% of "
        f"{peak / 1e12:.0f} TFLOP/s bf16 | {smi}")
    return dict(launches=launches, lsb=lsb, export_s=export_s,
                rtf=audio_s / t_bundle.median_s,
                live_rtf=audio_s / t_live.median_s, mfu=mfu)


def phase_tacotron2_bundle(smi: str, tmp: pathlib.Path) -> dict:
    """Phase 12's full-width Tacotron2 + HiFi-GAN V1 in bf16, decodes capped
    at T2_BUNDLE_STEPS, exported at batch 8 and the buckets the 16 prompts
    need, served by `Tacotron2ServingBundle` against the live
    `Tacotron2Wave(compute_dtype=bf16).tts(out_int16=True)`."""
    from tts_arabic_torch.apps import export_serving as es
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.text import tokens_to_ids
    prompts = load_prompts(N_PROMPTS)
    pipe = t2_pipe(compute_dtype=torch.bfloat16)
    m = pipe.model
    m.decoder_max_step = T2_BUNDLE_STEPS
    batches = _live_batches(prompts, lambda t: len(tokens_to_ids(
        m._prepare_tokens([t], None, True)[0][0], m.phon_to_id)))
    t0 = time.perf_counter()
    with generator_calls() as calls:
        live = pipe.tts(prompts, batch_size=BATCH, denoise=0.005,
                        out_int16=True)
    live_s = time.perf_counter() - t0
    text_buckets = sorted({tb for _, tb in batches})
    mel_buckets = sorted({c[1] for c in calls})
    t0 = time.perf_counter()
    out = es.export_bundle_tacotron(
        tmp / "tacotron2_bundle", batch_sizes=(BATCH,),
        text_buckets=text_buckets, mel_buckets=mel_buckets,
        max_steps=T2_BUNDLE_STEPS, device="cuda")
    export_s = time.perf_counter() - t0
    bundle = es.Tacotron2ServingBundle(out)
    _serve(bundle, prompts, batches)                # loads the programs
    rb.reset_launches()
    t0 = time.perf_counter()
    got = _serve(bundle, prompts, batches)
    torch.cuda.synchronize()
    bundle_s = time.perf_counter() - t0
    launches = dict(rb.LAUNCHES)
    want = {"resblock1_wide": 27 * len(batches),
            "resblock1_narrow": 3 * len(batches)}
    if launches != want:
        raise AssertionError(f"Tacotron2 bundle launches {launches}, "
                             f"expected {want}")
    lsb = _lsb(got, live)
    if lsb > BUNDLE_LSB:
        raise AssertionError(f"Tacotron2 bundle {lsb} LSB from the live "
                             f"path (> {BUNDLE_LSB})")
    audio_s = sum(w.size for w in live) / pipe.sample_rate
    log(f"[20 tacotron2 bundle] bf16, {T2_BUNDLE_STEPS} steps, batch "
        f"{BATCH}, text buckets {text_buckets}, mel buckets {mel_buckets}: "
        f"export {export_s:.1f} s, {len(list(out.glob('*.pt2')))} programs, "
        f"{_pt2_bytes(out)} bytes | Tacotron2ServingBundle vs live "
        f"tts(out_int16=True): max {lsb} LSB (gate {BUNDLE_LSB}) | launches "
        f"{launches} | {audio_s:.2f} s of audio: bundle {bundle_s:.2f} s "
        f"({audio_s / bundle_s:.1f}x real time), live (its first call, "
        f"eager decode) {live_s:.2f} s | {smi}")
    return dict(launches=launches, lsb=lsb, export_s=export_s)


def phase_op_route(smi: str) -> dict:
    """The live path's two routes to the ResBlock kernel: `resblock1` (the
    launch called directly) and the custom op `tts_arabic::resblock1` (the
    dispatcher, then the same launch). Each route's host cost a call at a
    streamed window's shapes, then phase 9's first-chunk pair and phase
    4's tts() through each, in turns (direct, op, op, direct)."""
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan

    def op_route(x, w1, b1, w2, b2, k, dilations):
        return torch.ops.tts_arabic.resblock1(
            x, rb.kernel_weights(w1, x.dtype), b1,
            rb.kernel_weights(w2, x.dtype), b2, k, list(dilations))

    routes = {"direct": rb.resblock1, "op": op_route}
    gen = torch.Generator(device="cuda").manual_seed(0)
    host_us = {}
    for name, fn in routes.items():
        per = []
        for C, T in ((256, 160 * 8), (32, 160 * 256)):
            x, w1, b1, w2, b2 = _case(C, 11, T, torch.bfloat16, gen, batch=1)
            fn(x, w1, b1, w2, b2, 11, DILATIONS)
            torch.cuda.synchronize()
            n = 200
            t0 = time.perf_counter()
            for _ in range(n):
                fn(x, w1, b1, w2, b2, 11, DILATIONS)
            per.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        host_us[name] = per
    prompts = load_prompts(N_PROMPTS)
    pipe = make_pipe(torch.bfloat16)
    capture(pipe)
    for n_joined in range(N_STREAM_PROMPTS, len(prompts) + 1):
        text = " ".join(prompts[:n_joined])     # phase 9's long utterance
        if pipe.model.ttmel(text).shape[1] > (
                STREAM_MIN_CHUNKS - 1) * STREAM_CHUNK:
            break
    kw = dict(chunk_frames=STREAM_CHUNK, overlap=STREAM_OVERLAP,
              denoise=0.005)
    ratios = {"direct": [], "op": []}
    rtfs = {"direct": [], "op": []}
    list(pipe.stream(text, **kw))
    pipe.tts(prompts, batch_size=BATCH, denoise=0.005)
    for name in ("direct", "op", "op", "direct"):
        with mock.patch.object(hifigan, "resblock1", routes[name]):
            firsts, fulls = first_and_whole(pipe, text, kw)
            ratios[name].append(min(firsts) / min(fulls))
            t0 = time.perf_counter()
            waves = pipe.tts(prompts, batch_size=BATCH, denoise=0.005)
            rtfs[name].append(sum(w.size for w in waves) / pipe.sample_rate
                              / (time.perf_counter() - t0))
    log(f"[20 op route] host us a call (C 256, 1280 rows; C 32, 40960 "
        f"rows; B = 1, bf16, k 11): direct {host_us['direct'][0]:.1f}, "
        f"{host_us['direct'][1]:.1f}; op {host_us['op'][0]:.1f}, "
        f"{host_us['op'][1]:.1f} | first chunk / whole tts_single (graphs "
        f"on both sides, min of 3), in turns direct, op, op, direct: "
        f"direct {', '.join(f'{r:.3f}' for r in ratios['direct'])}; op "
        f"{', '.join(f'{r:.3f}' for r in ratios['op'])} | tts() of the 16 "
        f"prompts, x real time: direct "
        f"{', '.join(f'{r:.1f}' for r in rtfs['direct'])}; op "
        f"{', '.join(f'{r:.1f}' for r in rtfs['op'])} | {smi}")
    return dict(host_us=host_us, ratios=ratios, rtfs=rtfs)


def _report(path: pathlib.Path) -> dict:
    report = json.loads(path.read_text())
    agg = report["aggregate"]
    if not agg or not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError(f"{path.name}: non-finite metrics {agg}")
    return report


def phase_offline_apps(smi: str, tmp: pathlib.Path,
                       phase7_ckpt: pathlib.Path) -> dict:
    """The offline apps on the card (their host work on the host), on a
    fresh copy of phase 6's corpus: preprocess audio/text/f0, evaluate
    (copy-synthesis, FastPitch from phase 7's `states.ckpt`, a seeded
    Tacotron2), export_torch of that checkpoint (its `.pth` served against
    the checkpoint), smoke_test of both models and download --verify with
    a stub fetcher. -> seconds per app."""
    from tts_arabic_torch.apps import (download, evaluate, export_torch,
                                       preprocess, smoke_test)
    from tts_arabic_torch.infer import FastPitch2Wave
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        return out

    config = write_corpus(tmp / "corpus")
    root = config.parent
    wavs = root / "wavs"
    n_wavs = len(list(wavs.glob("*.wav")))
    timed("preprocess audio", preprocess.main,
          ["audio", "--in-dir", str(wavs), "--out-dir", str(tmp / "pre")])
    done = sorted((tmp / "pre").glob("*.wav"))
    if len(done) != n_wavs:
        raise AssertionError(f"preprocess audio: {len(done)} of {n_wavs}")
    from tts_arabic_torch.audio import load_wav
    for p in done:
        x, sr = load_wav(p)
        if sr != SAMPLE_RATE or not np.isfinite(x).all() or len(x) < 768:
            raise AssertionError(f"preprocess audio: {p.name}")
    lines = arabic_lines(16)
    (tmp / "orth.txt").write_text(
        "".join(f"utt{i}|{t}\n" for i, t in enumerate(lines)),
        encoding="utf-8")
    timed("preprocess text", preprocess.main,
          ["text", "--transcript", str(tmp / "orth.txt"), "--out-dir",
           str(tmp / "text")])
    n_lines = sum(len((tmp / "text" / f"{s}_phon.txt").read_text(
        encoding="utf-8").splitlines()) for s in ("train", "test"))
    if n_lines != len(lines):
        raise AssertionError(f"preprocess text: {n_lines} of {len(lines)}")
    test_wavs = tmp / "test_wavs"
    test_wavs.mkdir()
    names = [parse.split('"')[1] for parse in
             (root / "test.txt").read_text().splitlines()]
    for name in names:
        (test_wavs / name).write_bytes((wavs / name).read_bytes())
    mean, std = timed("preprocess f0", preprocess.extract_f0, test_wavs,
                      tmp / "f0.npz")
    truth = np.load(root / "pitch_dict.npz")
    true_mean = np.mean(np.concatenate([truth[n] for n in names]))
    if not abs(mean - true_mean) < 0.1 * true_mean:
        raise AssertionError(f"f0 mean {mean:.1f} Hz vs the corpus's "
                             f"{true_mean:.1f}")

    # evaluate scores on the host (a DTW of pred x ref frames per metric),
    # so it takes the 3 shortest test utterances
    test_lines = (root / "test.txt").read_text().splitlines()
    short = sorted(test_lines, key=lambda line: len(line.split('"')[3]))[:3]
    (root / "short.txt").write_text("\n".join(short) + "\n")
    labels = ["--labels", str(root / "short.txt"), "--wav-dir", str(wavs)]
    timed("evaluate copy", evaluate.main,
          labels + ["--copy-synthesis", "--out", str(tmp / "copy.json")])
    copy = _report(tmp / "copy.json")
    zeros = [v for r in copy["per_utterance"] for k, v in r.items()
             if k == "mcd" or k.startswith(("mae_", "delta_u_"))]
    if any(v != 0.0 for v in zeros):
        raise AssertionError(f"copy-synthesis: nonzero {max(zeros)}")
    # phase 4's seeded FastPitch (durations biased +2.0) as a checkpoint
    biased = save_checkpoint(make_pipe(torch.bfloat16), tmp)
    timed("evaluate fastpitch", evaluate.main,
          labels + ["--checkpoint", str(biased), "--out",
                    str(tmp / "fp.json")])
    fp = _report(tmp / "fp.json")
    from tts_arabic_torch.eval import dtw
    dtw_calls = []
    native = dtw._dtw_native

    def timed_dtw(A, B, *a):
        t0 = time.perf_counter()
        out = native(A, B, *a)
        dtw_calls.append((A.shape[0], B.shape[0], time.perf_counter() - t0))
        return out

    with mock.patch.object(dtw, "_dtw_native", timed_dtw):
        timed("evaluate tacotron2", evaluate.main,
              labels + ["--model", "tacotron2", "--out",
                        str(tmp / "t2.json")])
    t2 = _report(tmp / "t2.json")
    dtw_s = sum(c[-1] for c in dtw_calls)
    # the native DTW and its plain numpy version at 3000 x 200 frames
    rng = np.random.default_rng(0)
    A = rng.normal(-4, 2, (3000, 80)).astype(np.float32)
    B = rng.normal(-4, 2, (200, 80)).astype(np.float32)
    t0 = time.perf_counter()
    cost, path = dtw.dtw_path(A, B)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain_cost, plain_path = dtw._dtw_numpy(A, B, 1, -1)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(path, plain_path)
            and abs(cost - plain_cost) <= 1e-5 * abs(plain_cost)):
        raise AssertionError("the native DTW differs from numpy's")
    log(f"[20 dtw] evaluate tacotron2: {len(dtw_calls)} DTW calls on the "
        f"native library (host C++, `csrc/dtw.cc`), shapes "
        f"{sorted({c[:2] for c in dtw_calls})}, {dtw_s:.3f} s of the app's "
        f"{secs['evaluate tacotron2']:.2f} s (with the numpy DTW: 22.9 s "
        f"for the app) | one cosine DTW of 3000 x 200 frames of 80: native "
        f"{native_ms:.1f} ms, numpy {plain_ms:.1f} ms, equal paths, costs "
        f"{cost!r} vs {plain_cost!r} | {smi}")

    pth = tmp / "fastpitch_phase7.pth"
    timed("export_torch", export_torch.main,
          ["--model", "fastpitch", "--checkpoint", str(phase7_ckpt), "--out",
           str(pth)])
    from tts_arabic_torch.runtime.checkpoint import load_states
    trained = load_states(phase7_ckpt)["model"]
    exported = torch.load(pth, weights_only=True)["model"]
    if exported.keys() != trained.keys() or not all(
            torch.equal(exported[k], v) for k, v in trained.items()):
        raise AssertionError("export_torch changed phase 7's weights")
    prompts = load_prompts(BATCH)
    waves = [FastPitch2Wave(src, arabic_in=False,
                            compute_dtype=torch.bfloat16).tts(
                                prompts, batch_size=BATCH, out_int16=True)
             for src in (phase7_ckpt, pth)]
    if any(a.shape != b.shape or not np.array_equal(a, b)
           for a, b in zip(*waves)):
        raise AssertionError("the exported .pth serves other waves than "
                             "its states.ckpt")
    served = sum(w.size for w in waves[0]) / SAMPLE_RATE

    for model, ckpt in (("fastpitch", biased), ("tacotron2", None)):
        out = tmp / f"smoke_{model}"
        argv = ["--model", model, "--out-dir", str(out)]
        timed(f"smoke_test {model}", smoke_test.main,
              argv + (["--checkpoint", str(ckpt)] if ckpt else []))
        if not ((out / "sample.wav").stat().st_size > 44
                and (out / "index.html").is_file()):
            raise AssertionError(f"smoke_test {model}: no wav or page")

    def fetcher(url, dest):             # a stub: nothing is fetched
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(pth.read_bytes())

    said = []
    art = tmp / "artifacts"
    rc_ok = timed("download verify", download.run_verify, art,
                  ["fastpitch_ar_mse.pth"], fetcher, said.append)
    bad = art / download.FILES["tacotron2_ar_mse.pth"]["path"]
    bad.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {"nonsense.weight": torch.zeros(2)}}, bad)
    rc_bad = download.run_verify(art, ["tacotron2_ar_mse.pth"], None,
                                 said.append)
    if (rc_ok, rc_bad) != (0, 1) or "OK" not in said[1] \
            or "FAIL" not in said[3]:
        raise AssertionError(f"download --verify: {rc_ok}, {rc_bad}: {said}")
    plotted = (tmp / "smoke_fastpitch" / "mel.png").exists()
    log(f"[20 apps] on a fresh copy of phase 6's corpus: preprocess audio "
        f"({n_wavs} wavs), text ({len(lines)} lines), f0 ({len(names)} "
        f"wavs: mean {mean:.1f} Hz against the corpus's {true_mean:.1f}, "
        f"std {std:.1f}) | evaluate on the {len(short)} shortest test "
        f"utterances: copy-synthesis MCD and every aligned delta 0, "
        f"FastPitch (phase 4's seeded weights) MCD "
        f"{fp['aggregate']['mcd']:.3f} dB, seeded Tacotron2 MCD "
        f"{t2['aggregate']['mcd']:.3f} dB, every metric finite | "
        f"export_torch of phase 7's states.ckpt: the same tensors, and the "
        f".pth serves its {len(prompts)} waves ({served:.2f} s) exactly | "
        f"smoke_test of both models (mel.png "
        f"{'written' if plotted else 'not written: no matplotlib'}) | "
        f"download --verify (stub fetcher): {said[1].split()[1]}, a corrupt "
        f"artifact {said[3].split()[1]} | seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" | {smi}")
    return secs


# ---- gate-controlled Tacotron2 ---------------------------------------------

GATE_STEPS = 768        # the JAX bench's Tacotron2 step cap (bench.py:66)
GATE_MIN_LEN = 86       # its floor on the gate stops, ~1 s (bench.py:73)
GATE_SPEAKERS = 64      # its config (bench.py:462-464)
GATE_MAX_FALLBACK = 2   # utterances that may decode to the cap off target


def gate_kernel_times(calls: list, smi: str) -> dict:
    """The bf16 ResBlock kernels at the stage shapes of phase 21's
    generator calls (`stage_kernel_times`), logged."""
    dt = torch.bfloat16
    out, rows = stage_kernel_times(calls, dt, 21)
    log(f"[21 gate kernels] bf16 at the generator call's stage shapes, "
        f"seeded inputs, err = max|kernel - plain f32| / max|plain| (<= "
        f"{TOL[dt]:.0e}), kernel/plain bf16/bound ms: " + "; ".join(rows)
        + " | " + "; ".join(
            f"{n}: {v['ms']:.3f} ms, plain {v['plain_ms']:.3f}, bound "
            f"{v['bound_ms']:.3f}" for n, v in out.items()) + f" | {smi}")
    return out


def phase_gate_control(smi: str, t2_rtf: float) -> dict:
    """Tacotron2Wave in bf16 with 64 speakers (the JAX bench's
    configuration) under `eval.gate_control`, on the 16 prompts at
    decoder_max_step GATE_STEPS and batch 16: the decode-block graph of
    the batch captured, then install_gate_control (calibration from an
    empty cache, then a second install that must replay it), tts() of the
    16 prompts with the counters set to 0 just before and read just after
    (the waves' lengths = the calibrated ones, 27 wide + 3 narrow
    launches a generator call, MAS 0), the gate channel's mels held bit
    for bit against speakers with it zeroed, three timed tts() and one
    under torch.profiler; the controlled decode's mels vocoded through the
    kernels and through the plain ResBlocks in f32 (SNR_GATE), and the
    kernels timed at the generator call's stage shapes. Returns the
    ResBlock launches of the counted tts() and, per variant, the times of
    `gate_kernel_times`."""
    from tts_arabic_torch.eval import install_gate_control
    from tts_arabic_torch.eval.gate_control import decode_in_tts_order
    from tts_arabic_torch.models.tacotron2 import Tacotron2Config
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    set_tf32(False)
    t_phase = time.perf_counter()
    prompts = load_prompts(N_PROMPTS)
    B = len(prompts)
    pipe = t2_pipe(compute_dtype=torch.bfloat16,
                   config=Tacotron2Config(num_speakers=GATE_SPEAKERS))
    m = pipe.model
    m.decoder_max_step = GATE_STEPS
    tokens = m.tokenize_batch(prompts)
    n_tokens = [len(t) for t in tokens]
    bucket = m._sorted_batch(tokens, 0, B)[0].shape[1]
    t0 = time.perf_counter()
    m.capture_graphs((B,), (bucket,))
    capture_s = time.perf_counter() - t0

    kw = dict(min_len=GATE_MIN_LEN)
    with tempfile.TemporaryDirectory(prefix="smoke_gate_cache_",
                                     dir=ROOT / "build") as cache, \
            mock.patch.dict("os.environ",
                            {"TTS_ARABIC_TORCH_GATE_CACHE": cache}):
        replays = m.graph_replays
        t0 = time.perf_counter()
        speakers, lengths, report = install_gate_control(pipe, prompts, **kw)
        cal_s = time.perf_counter() - t0
        cal_replays = m.graph_replays - replays
        t0 = time.perf_counter()
        spk2, len2, rep2 = install_gate_control(pipe, prompts, **kw)
        hit_s = time.perf_counter() - t0
    stops = sorted({int(n) for n in lengths if n < GATE_STEPS})
    log(f"[21 gate control] Tacotron2Config(num_speakers={GATE_SPEAKERS}) "
        f"bf16, HiFi-GAN V1 bf16, {B} prompts, batch {B}, decoder_max_step "
        f"{GATE_STEPS}, min_len {GATE_MIN_LEN}: capture_graphs() at batch "
        f"{B}, text {bucket}: {capture_s:.2f} s | install "
        f"{cal_s:.1f} s (cache {report['cache']}, {cal_replays} block "
        f"replays) | targets {report['targets']} | realized "
        f"{report['realized_lengths']} | off target {report['off_target']}"
        f", fired {report['n_fired']}, cap preferred "
        f"{report['cap_preferred']}, cap fallback {report['cap_fallback']} "
        f"| amplify {report['amplify']:g}, gap {report['gap']:g}, gate "
        f"channel {report['gate_channel']}, dither channel "
        f"{report['dither_channel']}, dithers {report['dithers']} | "
        f"second install {hit_s:.2f} s, cache {rep2['cache']} | {smi}")
    if report["cache"] != "miss" or rep2["cache"] != "hit" or not (
            np.array_equal(spk2, speakers) and np.array_equal(len2, lengths)):
        raise AssertionError(f"gate control: first install "
                             f"{report['cache']}, second {rep2['cache']} "
                             f"with {len2.tolist()} against "
                             f"{lengths.tolist()}")
    if report["cap_fallback"] > GATE_MAX_FALLBACK or len(stops) < 3:
        raise AssertionError(f"gate control: {report['cap_fallback']} cap "
                             f"fallbacks, distinct stops {stops}")

    tts_kw = dict(batch_size=B, denoise=0.005, speaker_id=speakers,
                  postprocess_mel=False, out_int16=True)
    with generator_calls() as calls:
        rb.reset_launches()
        mas_ops.reset_launches()
        waves = pipe.tts(prompts, **tts_kw)
        launches = dict(rb.LAUNCHES)
    want = {"resblock1_wide": 27 * len(calls),
            "resblock1_narrow": 3 * len(calls)}
    if launches != want or mas_ops.LAUNCHES["mas"]:
        raise AssertionError(f"gate-controlled tts() launches {launches}, "
                             f"expected {want}, mas 0")
    hop = pipe.hop_length
    realized = [len(w) // hop for w in waves]
    match = sum(r == n for r, n in zip(realized, lengths))
    for i, w in enumerate(waves):
        if not (w.ndim == 1 and w.dtype == np.int16 and w.size % hop == 0):
            raise AssertionError(f"gate-controlled prompt {i}: bad wave")
    if match != B:
        raise AssertionError(f"tts() lengths {realized} against the "
                             f"calibrated {lengths.tolist()}")
    log(f"[21 gate tts] tts(speaker_id=speakers, postprocess_mel=False, "
        f"out_int16=True): lengths = the calibrated ones {match}/{B}, "
        f"distinct stops {len(stops)} ({stops[0]}-{stops[-1]}) | "
        f"generator calls (mel shapes) {calls} | launches {launches}, mas 0")

    # the gate channel reaches only the gate: speakers B..2B-1 take
    # speakers 0..B-1's embedding with the gate channel zeroed
    emb = m.model.speaker_embedding.weight
    with torch.no_grad():
        emb[B: 2 * B] = emb[:B]
        emb[B: 2 * B, report["gate_channel"]] = 0.0
    ctl = decode_in_tts_order(m, prompts, speakers)
    ref = decode_in_tts_order(m, prompts, speakers + B)
    rows = ctl["mel_lens"].tolist()
    exact = sum(torch.equal(ctl["mel"][r, :L], ref["mel"][r, :L])
                for r, L in enumerate(rows))
    if exact != B or ref["mel_lens"].min() < GATE_STEPS:
        raise AssertionError(f"gate channel: {exact}/{B} rows bit-equal, "
                             f"the zeroed channel's lengths "
                             f"{ref['mel_lens'].tolist()}")
    log(f"[21 gate channel] speakers {B}-{2 * B - 1} = speakers 0-{B - 1} "
        f"with the gate channel zeroed: mels over each controlled row's "
        f"length bit-equal {exact}/{B}; those rows decode to the cap "
        f"{GATE_STEPS}")

    # the kernels against the plain ResBlocks in f32 on the controlled
    # decode's mels, vocoded as the counted tts() vocoded them
    mels = [ctl["mel_postnet"][r, :L].float().cpu().numpy().T
            for r, L in enumerate(rows)]
    wave_k, lens_k = pipe._dispatch_vocode(mels, 0.005)
    with mock.patch.object(hifigan, "resblock1", _plain_f32):
        wave_p, _ = pipe._dispatch_vocode(mels, 0.005)
    snrs = [snr_db(p, k) for k, p in zip(pipe._split_waves(wave_k, lens_k),
                                         pipe._split_waves(wave_p, lens_k))]
    gate = SNR_GATE[torch.bfloat16]
    log(f"[21 gate vocoder] the controlled decode's mels ({B} rows at "
        f"their lengths, one generator call of {max(rows)} frames): bf16 "
        f"kernels vs plain ResBlocks in f32, SNR min {min(snrs):.2f}, "
        f"median {float(np.median(snrs)):.2f} dB (> {gate}) | {smi}")
    if not min(snrs) > gate:
        raise AssertionError(f"gate-controlled vocoder SNR {snrs}")
    timed = gate_kernel_times(calls, smi)

    walls = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        waves = pipe.tts(prompts, **tts_kw)
        walls.append(time.perf_counter() - t0)
    audio_s = sum(w.size for w in waves) / pipe.sample_rate
    frames = int(sum(lengths))
    log(f"[21 gate rate] tts() {audio_s:.2f} s of audio ({frames} frames, "
        f"{frames / sum(n_tokens):.2f} frames a token over "
        f"{sum(n_tokens)} tokens): walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s = "
        f"{audio_s / min(walls):.1f}x real time (best of {N_TIMED}) | "
        f"phase 12's f32 decode to the 3000-step cap {t2_rtf:.1f}x | {smi}")

    got = profiled(lambda: pipe.tts(prompts, **tts_kw))
    if got is None:
        log(f"[21 gate profile] no device events recorded, not measured | "
            f"{smi}")
    else:
        wall, by_name, busy, n_ops = got
        rb_ms = sum(v for n, v in by_name.items() if "resblock1" in n)
        wide_ms = sum(v for n, v in by_name.items()
                      if "resblock1_pass" in n)
        rb_bound = {n: v["bound_ms"] for n, v in timed.items()}
        dev = sum(by_name.values())
        log(f"[21 gate profile] tts() under torch.profiler: wall "
            f"{wall * 1e3:.1f} ms, device busy {busy:.1f} ms (idle "
            f"{100 * (1 - busy / 1e3 / wall):.1f}%), {n_ops} device ops "
            f"summing {dev:.1f} ms | ResBlock kernels {rb_ms:.1f} ms = "
            f"{100 * rb_ms / dev:.1f}% of the device time: wide (bf16) "
            f"{wide_ms:.2f} ms, bound {rb_bound['resblock1_wide']:.3f}; "
            f"narrow {rb_ms - wide_ms:.2f} ms, bound "
            f"{rb_bound['resblock1_narrow']:.3f} | top: "
            + "; ".join(f"{n} {v:.1f} ms" for n, v in by_name.most_common(8))
            + f" | {smi}")
    log(f"[21] the phase: {time.perf_counter() - t_phase:.1f} s")
    del pipe, m, waves, ctl, ref, wave_k, wave_p
    torch.cuda.empty_cache()
    return launches, timed


# ---- the parallel layer: 2 ranks on one card -------------------------------

PAR_RANKS = 2           # ranks of phase 22's world, all on cuda:0
PAR_STEPS = 3           # DP FastPitch steps of phase 22
PAR_T2_ROWS = 8         # the DP Tacotron2 step's global batch
PAR_T2_FRAMES = 192     # its mels cut to this (phase 18's short batch)
PAR_SP_PROMPTS = 13     # phase 9's long utterance: these prompts joined
PAR_TIMEOUT = 300.0     # seconds a collective may wait for the other rank
PAR_TP_FRAMES = 2048    # the TP infer's mel bucket
PAR_LOSS_TOL = 1e-5     # DP against one process: loss terms, relative
PAR_GRAD_TOL = 1e-5     # DP against one process: gradients, of their norm
# 22a: the parameters after PAR_STEPS steps against the same steps in one
# process, of their norm. AdamW's first step moves an element by about
# lr * sign(g) whatever |g|, so elements whose gradient is rounding noise
# (an attention key bias, which the softmax cancels) step apart by 2 lr;
# they carried most of the 8.6e-6 to 9.4e-6 read on an H100 80GB HBM3 at
# 700 W (PERF.md section 6). The planted half-batch fault must miss by more.
PAR_PARAM_TOL = 2e-5
PAR_SP_TOL = 1e-5       # f32 sp_vocode: max |split - whole| / peak
# 22d: int16 waves, DP against one process (4 LSB in every run on an H100
# 80GB HBM3 at 700 W: bf16 decodes of 4 and of 8 rows round apart)
PAR_LSB = 8


def _flat(module, skip=lambda name: False) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float()
                      for n, p in module.named_parameters() if not skip(n)])


def _flat_grad(module) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1).float()
                      for p in module.parameters() if p.grad is not None])


def _synced(fn):
    """(fn(), seconds): host clock around work synchronized on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _launch_counts() -> dict:
    """Every kernel's launches since the counts were last reset."""
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    return {**rb.LAUNCHES, **mas_ops.LAUNCHES}


def _reset_launches() -> None:
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.ops import resblock as rb
    rb.reset_launches()
    mas_ops.reset_launches()


def _par_fastpitch(rank: int, inp: dict) -> dict:
    """Case a: PAR_STEPS DP FastPitch MSE steps of the global batches
    (dropout off), every kernel's launches counted around the DP steps and
    each MAS call's inputs and output kept. On rank 0 also: before each DP
    step a copy of its parameters takes the same step in one process (loss
    terms and gradients at the same point, which AdamW cannot amplify);
    the same steps from the initial weights in one process; and a planted
    fault, the steps on rank 0's half of each batch alone."""
    import dataclasses

    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.parallel import (data_parallel_jit, make_mesh,
                                           shard_batch)
    from tts_arabic_torch.train import steps
    mesh = make_mesh()
    cfg = FastPitchConfig(**{f.name: 0.0 for f in
                             dataclasses.fields(FastPitchConfig)
                             if "drop" in f.name})

    def state_():
        model = init_weights(FastPitch(cfg), 0).to("cuda")
        return steps.TrainState(model, steps.make_optimizer(model))

    step = steps.make_fastpitch_train_step(device="cuda")
    dp_step = data_parallel_jit(step, mesh)
    fused, mas_calls = mas_ops.mas_fused, []

    def recorded(log_attn, in_lens, out_lens):
        hard = fused(log_attn, in_lens, out_lens)
        mas_calls.append((log_attn, in_lens, out_lens, hard))
        return hard

    state = state_()
    shadow = state_() if rank == 0 else None
    launches = collections.Counter()
    metas, secs, forced = [], [], []
    for b in inp["fp_batches"]:
        pre = copy.deepcopy(state.model.state_dict()) if rank == 0 else None
        _reset_launches()
        with mock.patch.object(mas_ops, "mas_fused", recorded):
            meta, t = _synced(lambda: dp_step(state, b, 0))
        launches.update(_launch_counts())
        metas.append({k: float(v) for k, v in meta.items()})
        secs.append(t)
        if rank == 0:
            shadow.model.load_state_dict(pre)
            smeta = {k: float(v) for k, v in step(shadow, b, 0).items()}
            got, want = _flat_grad(state.model), _flat_grad(shadow.model)
            rel = {k: abs(metas[-1][k] - v) / max(abs(v), 1e-12)
                   for k, v in smeta.items()}
            worst = max(rel, key=rel.get)
            forced.append(dict(loss=metas[-1]["loss"], single=smeta["loss"],
                               term=worst, term_err=rel[worst],
                               grad_err=float((got - want).norm()
                                              / want.norm())))
    flat = _flat(state.model)
    # each rank's MAS calls against the plain MAS on the same soft
    # attention (counted launches were read above)
    mas_equal = [torch.equal(hard, mas_plain(la, il, ol))
                 for la, il, ol, hard in mas_calls]
    out = dict(metas=metas, secs=secs, launches=dict(launches),
               mas_equal=mas_equal,
               mas_shapes=[tuple(c[0].shape) for c in mas_calls],
               fingerprint=(float(flat.sum()), float(flat.norm())))
    del mas_calls, shadow
    if rank == 0:
        out["forced"] = forced
        single, fault = state_(), state_()
        single_secs = []
        for b in inp["fp_batches"]:
            single_secs.append(_synced(lambda: step(single, b, 0))[1])
            step(fault, shard_batch(b, mesh), 0)
        out["single_secs"] = single_secs
        ref = _flat(single.model)
        out["param_err"] = float((flat - ref).norm() / ref.norm())
        out["fault_err"] = float((_flat(fault.model) - ref).norm()
                                 / ref.norm())
    return out


def _par_tacotron(rank: int, inp: dict) -> dict:
    """Case b: one DP Tacotron2 MSE step (dropout off, BatchNorm's
    statistics over the global batch); on rank 0 the step in one
    process."""
    from tts_arabic_torch.models import tacotron2 as t2
    from tts_arabic_torch.parallel import data_parallel_jit, make_mesh
    from tts_arabic_torch.train import steps
    mesh = make_mesh()
    cfg = t2.Tacotron2Config(prenet_dropout=0.0,
                             attention_dropout=0.0, decoder_dropout=0.0)

    def state_():
        model = t2.init_tacotron2(t2.Tacotron2(cfg), 0).to("cuda")
        return steps.TrainState(model, steps.make_optimizer(
            model, 1e-3, grad_clip=1.0))

    def stats(model):
        return {k: v.detach().cpu() for k, v in model.state_dict().items()
                if "running" in k}

    step = steps.make_tacotron_train_step(device="cuda")
    with mock.patch.object(t2.Tacotron2, "_dropout",
                           lambda self, x, rate, gen: x):
        state = state_()
        meta, secs = _synced(lambda: data_parallel_jit(step, mesh)(
            state, inp["t2_batch"], 0))
        flat = _flat(state.model)
        out = dict(meta={k: float(v) for k, v in meta.items()}, secs=secs,
                   fingerprint=(float(flat.sum()), float(flat.norm())))
        if rank == 0:
            single = state_()
            smeta, out["single_secs"] = _synced(
                lambda: step(single, inp["t2_batch"], 0))
            out["single_meta"] = {k: float(v) for k, v in smeta.items()}
            # the gradients after the clip (the parameters follow from them
            # through the same AdamW step; an element whose gradient is
            # rounding noise, a conv bias before a training BatchNorm, may
            # step lr either way, so the parameters are not compared)
            got, ref = (_flat_grad(m.model) for m in (state, single))
            out["grad_err"] = float((got - ref).norm() / ref.norm())
            want = stats(single.model)
            got = stats(state.model)
            out["stats_err"] = max(float((got[k] - v).abs().max())
                                   for k, v in want.items())
    return out


def _row_snrs(calls, forward, dtype) -> list[float]:
    """Each recorded generator call's (mel, wave) vocoded again by
    `forward(mel)` with the ResBlocks on the plain version (f32 as is, TF32
    off; bf16 through `_plain_f32`); the SNR (dB) of every row's wave."""
    from tts_arabic_torch.ops import resblock as rb
    from tts_arabic_torch.vocoder import hifigan
    plain_rb = rb.resblock1_plain if dtype == torch.float32 else _plain_f32
    snrs = []
    with torch.no_grad(), mock.patch.object(hifigan, "resblock1", plain_rb):
        for mel, wave in calls:
            ref = forward(mel).float().cpu().numpy()
            got = wave.float().cpu().numpy()
            snrs += [snr_db(r, g) for r, g in zip(ref, got)]
    return snrs


def _par_sp(rank: int, inp: dict) -> dict:
    """Case c: sp_vocode of the joined mel through HiFi-GAN V1 in f32 and
    bf16 (and one frame shorter: ragged), and through Vocos (overlap 32),
    each against the whole call on this rank's card; every kernel's
    launches counted around each split call; this rank's own generator
    windows (HiFi-GAN) vocoded again on the plain ResBlocks; the halo
    exchange timed alone."""
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.parallel import make_mesh, sp_vocode
    from tts_arabic_torch.parallel.sp import _exchange
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    from tts_arabic_torch.vocoder.vocos import (CONFIG_22K, MelVocosModule,
                                                init_vocos)
    mesh = make_mesh()
    gen = init_weights(Generator(HiFiGANConfig()), 1).to("cuda").eval()
    vocos = init_vocos(MelVocosModule(**{
        k: v for k, v in CONFIG_22K.items() if k != "sample_rate"}),
        1).to("cuda").eval()
    mel = torch.from_numpy(inp["sp_mel"]).to("cuda")
    out = {}
    with torch.no_grad():
        for label, fn, x, kw in (
                ("f32", gen, mel, {}),
                ("bf16", gen, mel.to(torch.bfloat16), {}),
                ("ragged f32", gen, mel[:, :-1], {}),
                ("vocos f32", vocos, mel, dict(overlap=32))):
            calls = []

            def recording(win, fn=fn, calls=calls):
                wave = fn(win)
                calls.append((win, wave))
                return wave

            _reset_launches()
            got, secs = _synced(lambda: sp_vocode(recording, x, mesh, **kw))
            launches = _launch_counts()
            whole = fn(x).float().cpu().numpy()
            got = got.float().cpu().numpy()
            out[label] = dict(
                frames=int(x.shape[1]), launches=launches, secs=secs,
                windows=[tuple(w.shape) for w, _ in calls],
                shape_ok=got.shape == whole.shape,
                err=float(np.abs(got - whole).max()
                          / np.abs(whole).max()),
                snr=snr_db(whole, got),
                plain_snrs=(_row_snrs(calls, gen, x.dtype) if fn is gen
                            else None))
            del calls
        halo = mel[:, :32].contiguous()
        _exchange(halo, halo, mesh, "data")
        _, secs = _synced(lambda: [_exchange(halo, halo, mesh, "data")
                                   for _ in range(20)])
        out["halo_ms"] = secs / 20 * 1e3
        out["halo_bytes"] = halo.numel() * halo.element_size()
    return out


def _par_serving(rank: int, inp: dict) -> dict:
    """Case d: FastPitch2Wave(mesh=) in bf16 on the prompts at batch 8,
    every kernel's launches counted around the counted call and this
    rank's generator calls kept and vocoded again on the plain ResBlocks;
    on rank 0 the one-process tts(): the f32 waves' SNR, the int16 waves'
    largest difference."""
    from tts_arabic_torch.infer import FastPitch2Wave
    from tts_arabic_torch.parallel import make_mesh
    from tts_arabic_torch.vocoder.hifigan import Generator
    mesh = make_mesh()

    def pipe_(mesh):
        pipe = FastPitch2Wave(seed=0, arabic_in=False, mesh=mesh,
                              compute_dtype=torch.bfloat16,
                              device="cuda")
        with torch.no_grad():
            pipe.model.model.duration_predictor.fc.bias.add_(2.0)
        return pipe

    prompts = inp["prompts"]
    dp = pipe_(mesh)
    dp.tts(prompts, batch_size=BATCH)                       # warm
    forward, calls = Generator.forward, []

    def recording(self, mel, **kw):
        wave = forward(self, mel, **kw)
        calls.append((mel, wave))
        return wave

    _reset_launches()
    with mock.patch.object(Generator, "forward", recording):
        waves, secs = _synced(lambda: dp.tts(prompts, batch_size=BATCH))
    out = dict(launches=_launch_counts(), secs=secs,
               lens=[len(w) for w in waves],
               calls=[tuple(m.shape) for m, _ in calls],
               plain_snrs=_row_snrs(calls, dp.vocoder, torch.bfloat16))
    del calls
    codes = dp.tts(prompts, batch_size=BATCH, out_int16=True)
    if rank == 0:
        single = pipe_(None)
        single.tts(prompts, batch_size=BATCH)
        ref, out["single_secs"] = _synced(lambda: single.tts(
            prompts, batch_size=BATCH))
        out["single_lens"] = [len(w) for w in ref]
        out["snr"] = min(snr_db(b, a) for a, b in zip(waves, ref))
        ref = single.tts(prompts, batch_size=BATCH, out_int16=True)
        out["lsb"] = max(int(np.abs(a.astype(np.int32) - b).max())
                         for a, b in zip(codes, ref))
        out["seconds_of_audio"] = sum(len(w) for w in ref) / SAMPLE_RATE
    return out


def _par_tp(rank: int, inp: dict) -> dict:
    """Case e: tp_mel_infer_jit on a 1 x 2 (data x model) mesh at full
    width against the one-device infer (f32, TF32 off); the counted
    all-reduces a call."""
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.parallel import make_mesh_dp_tp, tp_mel_infer_jit
    mesh = make_mesh_dp_tp(1, PAR_RANKS)
    model = init_weights(FastPitch(FastPitchConfig()), 0)
    with torch.no_grad():
        model.duration_predictor.fc.bias.add_(2.0)
    model = model.to("cuda").eval()
    tokens = torch.from_numpy(inp["tp_tokens"]).to("cuda")
    fn, sharded = tp_mel_infer_jit(model, mesh, max_frames=PAR_TP_FRAMES)
    fn(sharded, tokens)                                     # warm
    sharded.collectives.clear()
    (mel, lens), secs = _synced(lambda: fn(sharded, tokens))
    calls = list(sharded.collectives)
    with torch.no_grad():
        ref, single_secs = _synced(lambda: model.infer(
            tokens, max_frames=PAR_TP_FRAMES))
    mel, want = mel.cpu().numpy(), ref["mel"].cpu().numpy()
    conv1 = sharded.encoder.layers[0].pos_ff.conv1.weight
    return dict(all_reduces=sum(op == "all_reduce" for op, _ in calls),
                reduced_widths=sorted({s[-1] for op, s in calls
                                       if op == "all_reduce"}),
                hidden=int(conv1.shape[0]), secs=secs,
                single_secs=single_secs,
                lens_equal=bool(torch.equal(lens.cpu(),
                                            ref["mel_lens"].cpu())),
                err=float(np.abs(mel - want).max()),
                within=bool(np.allclose(mel, want, rtol=2e-4, atol=2e-5)))


# the kernels line's per-rank keys and the paths they are counted on
PAR_PATHS = (("sp", "sp"), ("dp_serving", "serving"), ("dp_train", "train"))
PAR_CASES = (("a", _par_fastpitch), ("b", _par_tacotron), ("c", _par_sp),
             ("d", _par_serving), ("e", _par_tp))


def _par_rank(rank: int, world: int, store: str, inputs: str, queue) -> None:
    """One rank of phase 22 (spawned): joins the gloo group through the
    FileStore `store`, runs PAR_CASES in order, puts (rank, results) or
    (rank, traceback) on `queue`."""
    import pickle
    import traceback

    import torch.distributed as dist
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        sys.path.insert(0, str(ROOT))
        from tts_arabic_torch.parallel import init_multiprocess
        torch.cuda.set_device(0)
        set_tf32(False)
        # gloo, chosen here: NCCL refuses two ranks on one GPU
        init_multiprocess(f"file://{store}", world, rank, "gloo",
                          timeout=PAR_TIMEOUT)
        out = {}
        for name, case in PAR_CASES:
            out[name], out[f"{name} s"] = _synced(lambda: case(rank, inp))
        queue.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def par_inputs(root: pathlib.Path, prompts: list[str]) -> dict:
    """Phase 22's inputs: the synthetic corpus's first PAR_STEPS training
    batches (batch 10) and a Tacotron2 batch of its PAR_T2_ROWS shortest
    utterances cut to PAR_T2_FRAMES frames, phase 9's joined mel (phase
    4's bf16 pipeline's), the prompts and their tokens."""
    from tts_arabic_torch.data import ArabDataset, collate_tacotron
    from tts_arabic_torch.runtime.config import get_config
    config = write_corpus(root / "corpus")
    train, _ = training_batches(config)
    cfg = get_config(config)
    ds = ArabDataset(cfg.train_labels, cfg.train_wavs_path,
                     label_pattern=cfg.label_pattern)
    items = sorted((ds[i] for i in range(len(ds))),
                   key=lambda it: it[1].shape[1])[:PAR_T2_ROWS]
    t2_batch = collate_tacotron([(t, m[:, :PAR_T2_FRAMES]) for t, m in items])
    pipe = make_pipe(torch.bfloat16)
    mel = pipe.model.ttmel(" ".join(prompts[:PAR_SP_PROMPTS]))
    ids = [pipe.model.tokenize(t) for t in prompts[:BATCH]]
    tokens = np.zeros((BATCH, -(-max(map(len, ids)) // 16) * 16), np.int64)
    for i, x in enumerate(ids):
        tokens[i, : len(x)] = x
    del pipe
    return dict(fp_batches=train[:PAR_STEPS], t2_batch=t2_batch,
                sp_mel=np.ascontiguousarray(mel.T[None]), prompts=prompts,
                tp_tokens=tokens)


def run_ranks(inp: dict, tmp: pathlib.Path) -> dict:
    """Spawns PAR_RANKS ranks of `_par_rank` on `inp`, waits for them, and
    stops every one; -> {rank: results}."""
    import pickle
    path = tmp / "inputs.pkl"
    path.write_bytes(pickle.dumps(inp))
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_par_rank,
                         args=(r, PAR_RANKS, str(tmp / "store"), str(path),
                               queue)) for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    ranks = {}
    deadline = time.perf_counter() + 2 * PAR_TIMEOUT
    try:
        while len(ranks) < PAR_RANKS:
            try:
                rank, out = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(f"phase 22: ranks exited {dead} "
                                         "without a result") from None
                continue
            if isinstance(out, str):
                raise AssertionError(f"phase 22: rank {rank} failed:\n{out}")
            ranks[rank] = out
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"phase 22: a rank exited "
                                     f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return ranks


def _rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()
               if k != "grad_norm")


def phase_parallel(smi: str, prompts: list[str]) -> dict:
    """Phase 22 (see the module docstring): the parallel layer on
    PAR_RANKS ranks sharing cuda:0 over gloo. -> per-rank launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_parallel_",
                                     dir=ROOT / "build") as tmp:
        tmp = pathlib.Path(tmp)
        inp = par_inputs(tmp, prompts)
        t_in = time.perf_counter() - t0
        ranks = run_ranks(inp, tmp)
    r0 = ranks[0]
    every = range(PAR_RANKS)
    for case in ("a", "b"):
        prints = {ranks[r][case]["fingerprint"] for r in every}
        if len(prints) != 1:
            raise AssertionError(f"22{case}: the ranks' parameters differ: "
                                 f"{prints}")

    a = r0["a"]
    forced = a["forced"]
    term_err = max(f["term_err"] for f in forced)
    grad_errs = [f["grad_err"] for f in forced]
    grad_err = max(grad_errs)
    train = [ranks[r]["a"]["launches"] for r in every]
    mas_equal = [all(ranks[r]["a"]["mas_equal"]) for r in every]
    mas_calls = [len(ranks[r]["a"]["mas_equal"]) for r in every]
    rate = (PAR_STEPS - 1) / sum(a["secs"][1:])
    single_rate = (PAR_STEPS - 1) / sum(a["single_secs"][1:])
    log(f"[22a parallel] DP FastPitch MSE at full width, {PAR_RANKS} ranks "
        f"on cuda:0 over gloo, {PAR_STEPS} steps of global batch "
        f"{len(inp['fp_batches'][0]['tokens'])} "
        f"({tuple(inp['fp_batches'][0]['mel_tgt'].shape)}), dropout off, "
        f"f32 TF32 off: each step against the same step in one process from "
        f"the same parameters: losses {[f['loss'] for f in forced]} vs "
        f"{[f['single'] for f in forced]}, every term (grad_norm too) within "
        f"{term_err:.2e} relative (<= {PAR_LOSS_TOL:.0e}; the worst per step "
        f"{[f['term'] for f in forced]}), gradients "
        f"{[float(f'{g:.3g}') for g in grad_errs]} of "
        f"their norm (<= {PAR_GRAD_TOL:.0e}) | the {PAR_STEPS} steps from "
        f"the initial weights: parameters {a['param_err']:.3e} of their norm "
        f"from one process's (<= {PAR_PARAM_TOL:.0e}), equal on both ranks; "
        f"the planted fault (rank 0's half of each batch alone) "
        f"{a['fault_err']:.3e} (> {PAR_PARAM_TOL:.0e}) | MAS calls per rank "
        f"{mas_calls} at {ranks[0]['a']['mas_shapes']} (rank 0), bit-equal "
        f"to the plain MAS on the same soft attention {mas_equal} | "
        f"launches per rank {train} | {rate:.2f} steps/s (steps "
        f"2-{PAR_STEPS}) against one process's {single_rate:.2f} on the same "
        f"card | {smi}")
    want = {"resblock1_wide": 0, "resblock1_narrow": 0, "mas": PAR_STEPS}
    if (term_err > PAR_LOSS_TOL or grad_err > PAR_GRAD_TOL
            or a["param_err"] > PAR_PARAM_TOL
            or not a["fault_err"] > PAR_PARAM_TOL
            or not all(mas_equal) or mas_calls != [PAR_STEPS] * PAR_RANKS
            or any(t != want for t in train)):
        raise AssertionError("22a: DP FastPitch differs from one process")

    b = r0["b"]
    loss_err = _rel(b["meta"], b["single_meta"])
    log(f"[22b parallel] DP Tacotron2 MSE at full width, one step of "
        f"global batch {PAR_T2_ROWS} ({PAR_T2_ROWS // PAR_RANKS} a rank, "
        f"{tuple(inp['t2_batch']['mel_tgt'].shape)}), dropout off: loss "
        f"{b['meta']['loss']!r} vs {b['single_meta']['loss']!r}, terms "
        f"{loss_err:.2e} (<= {PAR_LOSS_TOL:.0e}) | BatchNorm running "
        f"statistics {b['stats_err']:.2e} (<= {PAR_GRAD_TOL:.0e}) | "
        f"gradients after the clip {b['grad_err']:.2e} of their norm (<= "
        f"{PAR_GRAD_TOL:.0e}) | step {b['secs']:.3f} s vs one process "
        f"{b['single_secs']:.3f} s | {smi}")
    if (loss_err > PAR_LOSS_TOL or b["stats_err"] > PAR_GRAD_TOL
            or b["grad_err"] > PAR_GRAD_TOL):
        raise AssertionError("22b: DP Tacotron2 differs from one process")

    for label in ("f32", "bf16", "ragged f32", "vocos f32"):
        got = [ranks[r]["c"][label] for r in every]
        dtype = torch.bfloat16 if label == "bf16" else torch.float32
        ok = all(g["shape_ok"] for g in got) and (
            min(g["snr"] for g in got) > SNR_GATE[dtype]
            if label == "bf16" else max(g["err"] for g in got) <= PAR_SP_TOL)
        errs = ", ".join(f"{g['err']:.2e}" for g in got)
        text = (f"[22c parallel] sp_vocode {label} of phase 9's joined mel "
                f"({got[0]['frames']} frames, {PAR_SP_PROMPTS} prompts) over "
                f"{PAR_RANKS} ranks against the whole call on the card: "
                f"max |split - whole| / peak per rank [{errs}] (<= "
                f"{PAR_SP_TOL:.0e} in f32), SNR "
                f"{[round(g['snr'], 2) for g in got]} dB | windows per rank "
                f"{[g['windows'] for g in got]} | launches per rank "
                f"{[g['launches'] for g in got]}")
        if got[0]["plain_snrs"] is not None:
            lows = [min(g["plain_snrs"]) for g in got]
            want = [{"resblock1_wide": 27 * len(g["windows"]),
                     "resblock1_narrow": 3 * len(g["windows"]), "mas": 0}
                    for g in got]
            ok = ok and min(lows) > SNR_GATE[dtype] and [
                g["launches"] for g in got] == want
            text += (f" (27 wide + 3 narrow a window) | each rank's windows "
                     f"on the plain ResBlocks in f32, min SNR of a row per "
                     f"rank {[round(x, 2) for x in lows]} dB (> "
                     f"{SNR_GATE[dtype]})")
        log(text + f" | {[round(g['secs'] * 1e3, 2) for g in got]} ms | "
            f"{smi}")
        if not ok:
            raise AssertionError(f"22c: sp_vocode {label} differs")
    log(f"[22c parallel] one halo exchange ({r0['c']['halo_bytes']} B each "
        f"way, staged through host memory for gloo): "
        f"{r0['c']['halo_ms']:.3f} ms | {smi}")

    d = r0["d"]
    lens = [ranks[r]["d"]["lens"] for r in every]
    serving = [ranks[r]["d"]["launches"] for r in every]
    lows = [min(ranks[r]["d"]["plain_snrs"]) for r in every]
    want = [{"resblock1_wide": 27 * len(ranks[r]["d"]["calls"]),
             "resblock1_narrow": 3 * len(ranks[r]["d"]["calls"]), "mas": 0}
            for r in every]
    log(f"[22d parallel] FastPitch2Wave(mesh=) bf16, the {len(prompts)} "
        f"prompts at batch {BATCH}: lengths equal to one process's "
        f"{all(x == d['single_lens'] for x in lens)}, min SNR of the f32 "
        f"waves {d['snr']:.2f} dB (> {SNR_GATE[torch.bfloat16]}), max "
        f"difference of the int16 waves {d['lsb']} LSB (<= {PAR_LSB}) | "
        f"generator calls per rank "
        f"{[ranks[r]['d']['calls'] for r in every]}, on the plain ResBlocks "
        f"in f32 min SNR of a row per rank {[round(x, 2) for x in lows]} dB "
        f"(> {SNR_GATE[torch.bfloat16]}) | launches per rank {serving} (27 "
        f"wide + 3 narrow a call) | "
        f"{d['seconds_of_audio'] / d['secs']:.1f}x real time vs one "
        f"process's {d['seconds_of_audio'] / d['single_secs']:.1f}x | {smi}")
    if (any(x != d["single_lens"] for x in lens)
            or not d["snr"] > SNR_GATE[torch.bfloat16]
            or d["lsb"] > PAR_LSB
            or not min(lows) > SNR_GATE[torch.bfloat16]
            or serving != want):
        raise AssertionError("22d: DP serving differs from one process")

    e = [ranks[r]["e"] for r in every]
    n_ffn = 12                          # 6 encoder + 6 decoder FFT blocks
    errs = ", ".join(f"{x['err']:.2e}" for x in e)
    log(f"[22e parallel] tp_mel_infer_jit at full width on a 1 x "
        f"{PAR_RANKS} mesh (d_inner split {PAR_RANKS} x {e[0]['hidden']}), "
        f"f32 TF32 off, {BATCH} prompts, bucket {PAR_TP_FRAMES}: lengths "
        f"equal {[x['lens_equal'] for x in e]}, max |mel - single| "
        f"[{errs}] "
        f"(rtol 2e-4, atol 2e-5: {[x['within'] for x in e]}) | all-reduces "
        f"a call {[x['all_reduces'] for x in e]} (expected {n_ffn}, "
        f"of width {e[0]['reduced_widths']}) | {e[0]['secs'] * 1e3:.1f} ms "
        f"vs one device {e[0]['single_secs'] * 1e3:.1f} ms | {smi}")
    if not all(x["lens_equal"] and x["within"]
               and n_ffn <= x["all_reduces"] <= n_ffn + 1 for x in e):
        raise AssertionError("22e: TP infer differs")
    secs = time.perf_counter() - t0
    log(f"[22 parallel] the phase: {secs:.1f} s (inputs {t_in:.1f} s; "
        f"the ranks' cases " + ", ".join(
            f"{c} {r0[f'{c} s']:.1f}" for c, _ in PAR_CASES) + f" s) | {smi}")
    kernels = ("resblock1_wide", "resblock1_narrow", "mas")
    return {path: {k: [counts[r][k] for r in every] for k in kernels}
            for path, counts in (
                ("train", train),
                ("sp", [ranks[r]["c"]["bf16"]["launches"] for r in every]),
                ("serving", serving))}


def main() -> int:
    global T_START
    T_START = time.perf_counter()
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
    summary = phase_kernel_checks([(b, f) for b, f, _ in shapes])
    launches, bf16_rtf = phase_main_path(
        pipe, prompts, shapes, sum(s["ms"] for s in summary.values()), smi)
    profile_tts(pipe, prompts, smi)
    del pipe
    phase_generator_check(smi, torch.float32)
    phase_generator_check(smi, torch.bfloat16)
    build_dir = ROOT / "build"      # git-ignored, inside the checkout
    build_dir.mkdir(exist_ok=True)
    # phase 20 exports phase 7's checkpoint; removed at the end (or at exit)
    keep = tempfile.TemporaryDirectory(prefix="smoke_phase20_",
                                       dir=build_dir)
    phase7_ckpt = pathlib.Path(keep.name) / "phase7_states.ckpt"
    with tempfile.TemporaryDirectory(prefix="smoke_corpus_",
                                     dir=build_dir) as tmp:
        config_path = write_corpus(pathlib.Path(tmp))
        train, val = training_batches(config_path)
        mas = phase_mas_checks(train, val)
        train_launches = phase_training(config_path, train, val, mas, smi)
        phase_step_check(train[0], smi)
        (pathlib.Path(tmp) / "ckpt_nawar_fp" / "states.ckpt").rename(
            phase7_ckpt)
    phase_stream_kernels()
    phase_stream(smi)
    phase_vowelizers(smi)
    with tempfile.TemporaryDirectory(prefix="smoke_apps_",
                                     dir=build_dir) as tmp:
        phase_apps(smi, pathlib.Path(tmp))
    t2_launches, t2_rtf, t2_timed = phase_tacotron2(smi)
    with tempfile.TemporaryDirectory(prefix="smoke_t2_apps_",
                                     dir=build_dir) as tmp:
        phase_tacotron2_apps(smi, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="smoke_int8_",
                                     dir=build_dir) as tmp:
        int8_launches = phase_int8(smi, bf16_rtf, pathlib.Path(tmp))
    phase_tacotron2_int8(smi)
    with tempfile.TemporaryDirectory(prefix="smoke_vocos_",
                                     dir=build_dir) as tmp:
        phase_vocos(smi, bf16_rtf, pathlib.Path(tmp))
    with tempfile.TemporaryDirectory(prefix="smoke_train_",
                                     dir=build_dir) as tmp:
        t0 = time.perf_counter()
        write_corpus(pathlib.Path(tmp))
        adv = phase_adversarial(pathlib.Path(tmp), smi)
        phase_tacotron_training(pathlib.Path(tmp), smi)
        log(f"[17-18] the two phases and their corpus: "
            f"{time.perf_counter() - t0:.1f} s")
        voc = phase_vocoder_training(pathlib.Path(tmp), smi)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_bundles_",
                                     dir=build_dir) as tmp:
        fp_bundle = phase_fastpitch_bundle(smi, pathlib.Path(tmp))
        t2_bundle = phase_tacotron2_bundle(smi, pathlib.Path(tmp))
    bundles_s = time.perf_counter() - t0
    phase_op_route(smi)
    t1 = time.perf_counter()
    phase_offline_apps(smi, pathlib.Path(keep.name), phase7_ckpt)
    keep.cleanup()
    log(f"[20] the phase: {time.perf_counter() - t0:.1f} s (the two bundles "
        f"{bundles_s:.1f} s, of it exports {fp_bundle['export_s']:.1f} + "
        f"{t2_bundle['export_s']:.1f} s; the apps "
        f"{time.perf_counter() - t1:.1f} s)")
    gate_launches, gate_timed = phase_gate_control(smi, t2_rtf)
    par = phase_parallel(smi, prompts)
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
            "library_ms": None,
            "tacotron2_launches": t2_launches[kname],
            # phase 12: the f32 (3xTF32) kernels at the counted Tacotron2
            # tts()'s stage shapes: kernel, plain (cuDNN f32, TF32 off),
            # 3xTF32 and CUDA-core bound ms and error, summed over its calls
            **{f"tacotron2_{k}": v for k, v in t2_timed[kname].items()},
            "int8_launches": int8_launches[kname],
            # phase 19: vocoder training's f32 launches, and their kernel,
            # plain, bound (3xTF32) and CUDA-core bound ms summed as timed
            # at the run's shapes
            "vocoder_train_launches": voc["launches"][kname],
            **{f"vocoder_train_{k}": voc["summed"][kname][i] for k, i in (
                ("ms", 0), ("plain_ms", 1), ("bound_ms", 2),
                ("cuda_core_ms", 5))},
            # phase 20: launches inside the exported wave programs while a
            # bundle served the 16 prompts (FastPitch, Tacotron2)
            "bundle_launches": fp_bundle["launches"][kname],
            "tacotron2_bundle_launches": t2_bundle["launches"][kname],
            # phase 21: the gate-controlled bf16 Tacotron2's counted tts(),
            # and its kernel, plain and bound ms and error summed over the
            # stage shapes of its generator call
            "tacotron2_gate_launches": gate_launches[kname],
            **{f"tacotron2_gate_{k}": v
               for k, v in gate_timed[kname].items()},
            # phase 22: each rank's launches counted around its bf16
            # sp_vocode call, its counted FastPitch2Wave(mesh=).tts() and
            # its DP training steps
            **{f"{path}_launches_per_rank": par[key][kname]
               for path, key in PAR_PATHS}})
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
        "bound_by": "bytes", "library_ms": None, "tacotron2_launches": 0,
        "int8_launches": 0, "adversarial_launches": adv["launches"],
        "adversarial_ms": adv["mas_ms"], "vocoder_train_launches": 0,
        "bundle_launches": 0, "tacotron2_bundle_launches": 0,
        "tacotron2_gate_launches": 0,
        # phase 22: each rank's launches, as above
        **{f"{path}_launches_per_rank": par[key]["mas"]
           for path, key in PAR_PATHS}})
    log(smi)
    log(f"[smoke] every phase passed in {time.perf_counter() - T_START:.1f} "
        "s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
