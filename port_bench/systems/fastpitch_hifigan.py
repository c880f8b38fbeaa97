"""FastPitch + HiFi-GAN + the denoiser, as the port serves them, built from
a configuration file, and held against the plain reference.

The benchmark makes the weights on the card from the seed (the published
layout, `reference.fastpitch.param_specs` and `reference.hifigan.
param_specs`), sets the duration head as the configuration says, and writes
them as published-layout checkpoints under the run's work directory, which the
program loads through its public constructor (`FastPitch2Wave(
model_sd_path=, vocoder_sd=, vocoder_config=)`). The reference reads the same
state dicts.

What the check reads of the timed path, besides its outputs, is taken
from outside at three calls: `FastPitchTTS._encode_batch` (the program's
token ids of each utterance and its predicted durations),
`FastPitchTTS._decode_fn` (the frames each batch was decoded at, its mel
bucket) and `vocoder.denoiser.denoise` (the denoiser's input and output).
Where a call is not there to be watched, the check still gives a reading:
an utterance with no bucket is padded by `FALLBACK_PAD_FRAMES`, one with no
record counts as unmatched, and a window in which no denoiser call was seen
reads as a skipped denoiser.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import time
from unittest import mock

import numpy as np
import torch

from port_bench import harness, yardstick
from port_bench.reference import fastpitch as ref_fp
from port_bench.reference import hifigan as ref_hg
from port_bench.reference import tokens as ref_tokens

LOG_MEL_PAD = math.log(1e-5)     # the published pipeline's silence padding
# silence the reference pads an utterance's mel with where its bucket was
# not seen: past the generator's receptive field (about 13 frames a side)
# and the denoiser's STFT window (4 frames), so the utterance's own samples
# do not depend on it
FALLBACK_PAD_FRAMES = 64
_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def make_weights(config: dict, seed: int, device) -> dict:
    """{"fastpitch": state dict, "hifigan": state dict} on the host, made
    on `device` from `seed` in one draw, the generator's biases scaled by
    the recipe's `hifigan_bias_scale`, the duration head then scaled and
    biased (`calibrate_durations`)."""
    net, h = config["fastpitch"], config["hifigan"]
    scale = config["weights"]["hifigan_bias_scale"]
    fp_specs = ref_fp.param_specs(net)
    hg_specs = [(n, shape, ("normal", init[1] * scale)
                 if n.endswith(".bias") else init)
                for n, shape, init in ref_hg.param_specs(h)]
    sd = harness.seeded_state_dict(fp_specs + [("hifigan." + n, s, i)
                                               for n, s, i in hg_specs],
                                   seed, device)
    fp = {n: sd[n] for n, _, _ in fp_specs}
    hg = {n: sd["hifigan." + n] for n, _, _ in hg_specs}
    calibrate_durations(fp, net, config["weights"]["durations"], device)
    return {"fastpitch": fp, "hifigan": hg}


def calibrate_durations(fp: dict, net: dict, spec: dict, device) -> None:
    """A random duration head predicts a seed-dependent speech rate, with a
    heavy tail (exp of a wide normal), so the work of a call would change
    with the seed. Its weight and bias are set, in place, so that over
    every token of the prompts `spec["prompts"]` its log(1 + frames) has
    the mean and standard deviation of a log-normal duration of
    `spec["mean_frames"]` frames a token and `spec["log_std"]`: the
    reference's float32 encode on the card, one utterance at a time."""
    from port_bench import traffic
    w, b = "duration_predictor.fc.weight", "duration_predictor.fc.bias"
    fp[b] = torch.zeros_like(fp[b])
    dev_sd = {k: v.to(device) for k, v in fp.items()}
    with precision(tf32=False):
        z = torch.cat([ref_fp.log_durations(dev_sd, net, ref_tokens.ids(t))
                       for t in traffic.prompts(spec)]).double()
    sigma = spec["log_std"]
    mean = math.log(1.0 + spec["mean_frames"]) - 0.5 * sigma ** 2
    scale = sigma / float(z.std())
    fp[w] = fp[w] * scale
    fp[b] = torch.full_like(fp[b], mean - scale * float(z.mean()))


def write_checkpoints(config: dict, weights: dict,
                      workdir: pathlib.Path) -> dict:
    workdir.mkdir(parents=True, exist_ok=True)
    paths = {"checkpoint": workdir / "fastpitch.pth",
             "vocoder_sd": workdir / "hifigan.pth",
             "vocoder_config": workdir / "hifigan.json"}
    torch.save({"model": weights["fastpitch"],
                "config": config["fastpitch"]}, paths["checkpoint"])
    torch.save({"generator": weights["hifigan"]}, paths["vocoder_sd"])
    paths["vocoder_config"].write_text(json.dumps(config["hifigan"]))
    return {k: str(v) for k, v in paths.items()}


def remove_checkpoints(paths: dict) -> None:
    for p in paths.values():
        pathlib.Path(p).unlink(missing_ok=True)


def pipeline(config: dict, paths: dict, device, quantize=None):
    """The port's `FastPitch2Wave` on the benchmark's checkpoints."""
    from tts_arabic_torch.infer import FastPitch2Wave
    return FastPitch2Wave(
        model_sd_path=paths["checkpoint"], vocoder_sd=paths["vocoder_sd"],
        vocoder_config=paths["vocoder_config"], arabic_in=False,
        compute_dtype=_DTYPES[config["compute_dtype"]], device=device,
        quantize=quantize)


class Records:
    """What the timed path decided in the calls since the last `take`."""

    def __init__(self, rows: dict, denoised: list):
        self.rows = rows            # key(token ids) -> (durations, frames)
        self.denoised = denoised    # [(denoiser input, output)], [B, T]


class Capture:
    """Records, from outside, what the timed path decided for each
    utterance: its token ids, its predicted durations (a device row, read
    only after the window) and the frames its batch was decoded at; and
    each denoiser call's input and output (device tensors, held, not
    copied)."""

    def __init__(self):
        self._rows = {}       # token ids' bytes -> (durations, row, length)
        self._buckets = []    # (durations tensor, frames decoded at)
        self._denoised = []

    @contextlib.contextmanager
    def installed(self):
        from tts_arabic_torch.infer.pipeline import FastPitchTTS
        from tts_arabic_torch.vocoder import denoiser
        cap = self
        patches = []
        encode_batch = getattr(FastPitchTTS, "_encode_batch", None)
        decode_fn = getattr(FastPitchTTS, "_decode_fn", None)
        denoise_fn = getattr(denoiser, "denoise", None)

        def encode(self, ids_list, *a, **kw):
            out = encode_batch(self, ids_list, *a, **kw)
            enc, inverse, n_real = out
            for i in range(n_real):
                ids = np.asarray(ids_list[i], np.int64)
                cap._rows[ids.tobytes()] = (enc["dur_pred"], inverse[i],
                                            len(ids))
            return out

        def decode(self, enc_out, durations, pace, **kw):
            cap._buckets.append((durations, kw.get("max_frames")))
            return decode_fn(self, enc_out, durations, pace, **kw)

        def denoise(audio, *a, **kw):
            out = denoise_fn(audio, *a, **kw)
            cap._denoised.append((audio, out))
            return out

        if encode_batch is not None:
            patches.append(mock.patch.object(FastPitchTTS, "_encode_batch",
                                             encode))
        if decode_fn is not None:
            patches.append(mock.patch.object(FastPitchTTS, "_decode_fn",
                                             decode))
        if denoise_fn is not None:
            patches.append(mock.patch.object(denoiser, "denoise", denoise))
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            yield self

    def take(self) -> Records:
        """The records since the last take, still on the device."""
        rows, buckets = self._rows, self._buckets
        denoised = self._denoised
        self._rows, self._buckets, self._denoised = {}, [], []
        out = {}
        for ids, (dur, r, n) in rows.items():
            frames = [f for d, f in buckets if d is dur]
            out[ids] = (dur[r, :n], frames[0] if frames else None)
        return Records(out, denoised)


def key(ids) -> bytes:
    """The record key of a token-id sequence."""
    return np.asarray(ids, np.int64).tobytes()


@contextlib.contextmanager
def precision(tf32: bool):
    """No gradients, and float32 matmuls and convs in full float32 unless
    `tf32`."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Reference:
    """The plain reference on the benchmark's weights, in float32 with
    TF32 off unless `tf32`."""

    def __init__(self, config: dict, weights: dict, device,
                 tf32: bool = False):
        self.net, self.h = config["fastpitch"], config["hifigan"]
        self.fp = {k: v.to(device) for k, v in weights["fastpitch"].items()}
        self.hg = {k: v.to(device) for k, v in weights["hifigan"].items()}
        self.hop = ref_hg.hop_length(self.h)
        self.tf32 = tf32
        with self.precision():
            self.bias = ref_hg.bias_spectrum(self.hg, self.h)

    def denoise(self, wave: torch.Tensor, strength: float) -> torch.Tensor:
        """The reference denoiser on waves [..., T] (float32)."""
        with self.precision():
            return ref_hg.denoise(wave.float(), self.bias, strength)

    def precision(self):
        return precision(self.tf32)

    def durations(self, ids) -> np.ndarray:
        with self.precision():
            return ref_fp.encode(self.fp, self.net, ids)["dur"].cpu().numpy()

    def vocoded(self, ids, reps: np.ndarray, pad_to: int) -> torch.Tensor:
        """The utterance's wave before the denoiser, with these (integer)
        durations, its mel padded with silence to `pad_to` frames before
        the vocoder, as the pipeline pads a batch to its bucket: all
        `pad_to` frames' samples, on the device."""
        with self.precision():
            enc = ref_fp.encode(self.fp, self.net, ids)
            mel = ref_fp.decode(self.fp, self.net, enc["enc_out"],
                                torch.as_tensor(reps,
                                                device=enc["dur"].device))
            pad = torch.full((max(pad_to - mel.shape[0], 0), mel.shape[1]),
                             LOG_MEL_PAD, device=mel.device)
            return ref_hg.generate(self.hg, self.h, torch.cat([mel, pad]))

    def wave(self, ids, reps: np.ndarray, pad_to: int,
             denoise: float) -> np.ndarray:
        """The utterance's own samples of `vocoded`, denoised."""
        wave = self.vocoded(ids, reps, pad_to)
        if denoise > 0:
            wave = self.denoise(wave, denoise)
        return wave[: int(reps.sum()) * self.hop].cpu().numpy()


def check(samples: list, denoised: list, reference: Reference,
          denoise: float) -> dict:
    """The numbers that decide `correct`, over the sampled utterances
    [(text, wave in [-1, 1], Records of its call)] and the denoiser calls
    of the sampled calls [(input, output)]:

    - tokens_mismatched: utterances whose token ids the program's timed
      path did not encode as the reference's frontend gives them (or of
      which it left no record);
    - dur_gap_frames: the largest gap between a token's predicted duration
      (frames, before rounding) in the program and in the reference;
    - frames_mismatched: utterances whose wave is not hop x the sum of the
      program's rounded durations long;
    - wave_rel_err: the largest ||wave - reference|| / ||reference|| of an
      utterance;
    - denoise_rel_err: the largest ||output - reference denoiser(input)||
      / ||reference denoiser(input) - input|| of a row of a denoiser call:
      the program's denoiser against what the reference's takes off the
      same wave; 1.0, a skipped denoiser's reading, where the calls
      denoised and no denoiser call was seen.

    The reference length-regulates with the program's rounded durations,
    which dur_gap_frames holds to its own (they differ only where a
    duration lies within that gap of a half frame). It pads each mel to
    the frames its batch was decoded at, or by FALLBACK_PAD_FRAMES where
    that was not seen."""
    out = {"tokens_mismatched": 0, "dur_gap_frames": 0.0,
           "frames_mismatched": 0, "wave_rel_err": 0.0,
           "denoise_rel_err": 0.0}
    for text, wave, records in samples:
        ids = ref_tokens.ids(text)
        if key(ids) not in records.rows:
            out["tokens_mismatched"] += 1
            continue
        dur, frames_at = records.rows[key(ids)]
        dur = dur.float().cpu().numpy()
        out["dur_gap_frames"] = max(out["dur_gap_frames"], float(
            np.abs(dur - reference.durations(ids)).max()))
        reps = np.floor(dur + 0.5).astype(np.int64)
        frames = int(reps.sum())
        if len(wave) != frames * reference.hop:
            out["frames_mismatched"] += 1
            continue
        pad_to = frames_at if frames_at is not None else (
            frames + FALLBACK_PAD_FRAMES)
        ref = reference.wave(ids, reps, pad_to, denoise)
        err = np.linalg.norm(wave - ref) / max(np.linalg.norm(ref), 1e-30)
        out["wave_rel_err"] = max(out["wave_rel_err"], float(err))
    if denoise > 0 and not denoised:
        out["denoise_rel_err"] = 1.0
    for audio, got in denoised:
        want = reference.denoise(audio, denoise)
        taken = torch.linalg.vector_norm(want - audio.float(), dim=-1)
        gap = torch.linalg.vector_norm(got.float() - want, dim=-1)
        out["denoise_rel_err"] = max(out["denoise_rel_err"], float(
            (gap / taken.clamp_min(1e-30)).max()))
    return out


# ---- what the per-layer readers count -----------------------------------------

def utterance_flops(config: dict, n_tokens: int, n_frames: int) -> int:
    """Model FLOPs of one utterance at its own tokens and frames: encode,
    decode and the generator (the benchmark's frozen counts)."""
    net, h = config["fastpitch"], config["hifigan"]
    return (yardstick.fastpitch_encode_flops(net, n_tokens)
            + yardstick.fastpitch_decode_flops(net, n_tokens, n_frames)
            + n_frames * yardstick.generator_flops_per_frame(h))


@contextlib.contextmanager
def generator_calls(vocoder):
    """The mel shape [B, frames, n_mel] of every generator call inside."""
    calls = []
    handle = vocoder.register_forward_pre_hook(
        lambda mod, args: calls.append(tuple(args[0].shape)))
    try:
        yield calls
    finally:
        handle.remove()


# ---- the program as a driver sees it ---------------------------------------------

class Program:
    """The program of one run: the port's pipeline on the benchmark's
    seeded weights. `quantize="int8"` switches on the program's own int8
    path (the control)."""

    def __init__(self, cell, seed: int, device, workdir: pathlib.Path,
                 quantize=None):
        self.config, self.mix = cell.config, cell.traffic
        self.device = torch.device(device)
        self.setup_spans = {}
        t = time.perf_counter()
        self.weights = make_weights(self.config, seed, self.device)
        self.setup_spans["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        paths = write_checkpoints(self.config, self.weights, workdir)
        self.setup_spans["checkpoints written"] = time.perf_counter() - t
        t = time.perf_counter()
        try:
            self.pipe = pipeline(self.config, paths, self.device, quantize)
        finally:
            remove_checkpoints(paths)
        self.setup_spans["program built"] = time.perf_counter() - t
        self.capture = Capture()
        self.vocoder = self.pipe.vocoder
        self.hop = self.pipe.hop_length
        self.sample_rate = self.pipe.sample_rate
        self.dtype = self.config["compute_dtype"]
        self._n_tokens = {}

    def warm(self, calls) -> None:
        """Set-up: every call of the mix once."""
        t = time.perf_counter()
        for texts in calls:
            self.call(texts)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_spans["warm-up"] = time.perf_counter() - t

    def call(self, texts: list) -> list:
        return self.pipe.tts(texts, batch_size=self.mix["batch_size"],
                             denoise=self.mix["denoise"])

    def generator_calls(self):
        return generator_calls(self.vocoder)

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.pipe = self.vocoder = None
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, samples: list, denoised: list) -> dict:
        """`check` of the sampled requests [(text, wave, Records)] and
        denoiser calls against a Reference made now (call after `free`)."""
        ref = Reference(self.config, self.weights, self.device)
        return check([(t, np.asarray(w, np.float32), r)
                      for t, w, r in samples], denoised, ref,
                     self.mix["denoise"])

    def n_tokens(self, text: str) -> int:
        if text not in self._n_tokens:
            self._n_tokens[text] = len(ref_tokens.ids(text))
        return self._n_tokens[text]

    def flops(self, text: str, n_samples: int) -> int:
        return utterance_flops(self.config, self.n_tokens(text),
                               n_samples // self.hop)

    def describe(self, served: list) -> str:
        """A line on the work the window served."""
        tokens = sum(self.n_tokens(t) for t, _ in served)
        frames = sum(n for _, n in served) // self.hop
        return (f"served {len(served)} utterances, {tokens} tokens, "
                f"{frames} frames ({frames / max(tokens, 1):.3f} a token) | "
                "set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                       self.setup_spans.items()))
