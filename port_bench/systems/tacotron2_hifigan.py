"""Tacotron2 + HiFi-GAN + the denoiser, as `Tacotron2Wave.tts()` serves them,
built from a configuration file, made to stop by gate control, and held
against the plain reference.

The benchmark makes the weights on the card from the seed (the published
layout, `reference.tacotron2.param_specs` and `reference.hifigan.
param_specs`) and writes them as published-layout checkpoints under the
run's work directory, which the program loads through its public
constructor (`Tacotron2Wave(model_sd_path=, vocoder_sd=, vocoder_config=,
config=, compute_dtype=)`). A random Tacotron2's gate never fires, so set-up
rewires the loaded model with the program's gate control
(`eval.gate_control.install_gate_control`, its defaults but the
configuration's `min_len` and targets of `frames_per_token`, no cache) on
the call's texts, so that each row stops near its target; the speakers it
returns go with every call.
The rewired model is part of the configuration: the reference reads the
program's Tacotron2 state after the window, and the check holds every leaf
but the ones gate control names (`REWIRED`) bit-equal to the seeded ones.

What the check reads of the timed path, besides its outputs, is taken from
outside at three calls: `Tacotron2TTS._infer` (each batch's padded token
ids, speakers and the decode's outputs: the mel, the postnet's mel, the
gate logits and the lengths), `Tacotron2Wave._assemble_fn` (the mel bucket
the batch was vocoded at) and `vocoder.denoiser.denoise` (the denoiser's
input and output). Where a call is not there to be watched, the check
still gives a reading: an utterance with no bucket is padded by
`FALLBACK_PAD_FRAMES`, one with no decode record counts as unmatched, and a
window in which no denoiser call was seen reads as a skipped denoiser.

The decode is held against the reference teacher-forced, not free-running:
gate control stops each row where a bisection against the program's own
decode put the gate logit just over the threshold, so a free-running
float32 decode would stop elsewhere. Each of the reference's steps takes
the program's previous frame and the program's prenet masks (redrawn by
its rule), and its own float32 attention and LSTM states.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import time
from unittest import mock

import numpy as np
import torch

from port_bench import harness, yardstick, yardstick_tacotron2
from port_bench.reference import hifigan as ref_hg
from port_bench.reference import tacotron2 as ref_t2

FP = harness.load_plugin("systems", "fastpitch_hifigan")
FALLBACK_PAD_FRAMES = FP.FALLBACK_PAD_FRAMES
LOG_MEL_PAD = FP.LOG_MEL_PAD

# the state-dict leaves gate control rewrites (its named ones)
REWIRED = ("decoder.attention_layer.memory_layer.linear_layer.weight",
           "decoder.attention_rnn.weight_ih",
           "decoder.decoder_rnn.weight_ih",
           "decoder.linear_projection.linear_layer.weight",
           "speaker_embedding.weight",
           "decoder.gate_layer.linear_layer.weight",
           "decoder.gate_layer.linear_layer.bias")


def make_weights(config: dict, seed: int, device,
                 pointer: bool = True) -> dict:
    """{"tacotron2": state dict, "hifigan": state dict} on the host, made
    on `device` from `seed` in one draw, the generator's biases scaled by
    the recipe's `hifigan_bias_scale`, then the recipe's pointer set
    (`construct_pointer`) unless `pointer` is false."""
    scale = config["weights"]["hifigan_bias_scale"]
    t2_specs = ref_t2.param_specs(config["tacotron2"])
    hg_specs = [(n, shape, ("normal", init[1] * scale)
                 if n.endswith(".bias") else init)
                for n, shape, init in ref_hg.param_specs(config["hifigan"])]
    sd = harness.seeded_state_dict(t2_specs + [("hifigan." + n, s, i)
                                               for n, s, i in hg_specs],
                                   seed, device)
    t2 = {n: sd[n].clone() for n, _, _ in t2_specs}
    for n in t2:
        if n.endswith("num_batches_tracked"):
            t2[n] = torch.zeros((), dtype=torch.long)
    if pointer:
        construct_pointer(t2, config["tacotron2"],
                          config["weights"]["pointer"])
    return {"tacotron2": t2,
            "hifigan": {n: sd["hifigan." + n] for n, _, _ in hg_specs}}


def construct_pointer(t2: dict, cfg: dict, spec: dict) -> None:
    """Set, in place, the few leaves that make the seeded decoder behave
    as a trained one does on the path the cell measures: an attention that
    moves along the text, and a gate that reads how far it has moved.

    A random decoder settles within some tens of steps: its attention stays
    spread over the text and its gate logit flat, so gate control's stops
    would land on rounding noise (PERF.md). Here:

    - two units of the encoder's forward LSTM (`counter_unit`,
      `constant_unit`; their four gates' rows, every input weight zero)
      carry the position, tanh((j + 1) x `counter_step`) at token j, and a
      constant, tanh(tanh(1)), into the memory;
    - the attention (query, memory and location layers, v) is a pointer:
      with w the previous weights and cum their running sum at each
      position j, the energy is kA tanh(a w[j-1] + b w[j] - c cum[j]) (the
      step to the next token once the current one has been attended
      about (b - a) / c steps) + kB tanh(alpha (w[j-1] + w[j]) - beta)
      (only the current and the next token are open) + kC tanh(-s
      position[j]) (the start at the first token); every other weight of
      those layers is zero. With the other units' draws kept and live,
      the query term dropped moved none of the cell's compared numbers
      past its sound runs (the pointer pins the weights), and the longest
      row's stop moved with the seed (PERF.md §2, §6); the drawn attention is
      held to the reference on the CPU instead
      (`tests/test_torch_port_tacotron_reference.py`);
    - the gate layer reads the context's position channel with weight
      `gate_position` and, of its other inputs, only the speaker channels
      that gate control rewires: its weights on the decoder LSTM's output
      and on the other memory channels are zero. So the gate logit is a
      step function of the attended position, in bf16 the same on every
      seed, and so are the steps gate control can stop a row at: with
      those weights drawn, the stops near a row's target moved with the
      seed's noise, the longest row's across the 1,536-frame mel bucket
      (PERF.md §4), and with it the decode's steps and the vocoder's work.

    Every other leaf keeps its draw."""
    H = cfg["encoder_embedding_dim"] // 2
    u, k = spec["counter_unit"], spec["constant_unit"]
    big = 20.0                      # sigmoid(20) is 1.0 in float32
    for unit, forget, cell in ((u, big, math.atanh(spec["counter_step"])),
                               (k, -big, 1.0)):
        rows = [unit + q * H for q in range(4)]         # gates i, f, g, o
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_hh_l0"):
            t2[f"encoder.lstm.{name}"][rows] = 0.0
        t2["encoder.lstm.bias_ih_l0"][rows] = torch.tensor(
            [big, forget, cell, big])
    constant = math.tanh(math.tanh(1.0))
    att = "decoder.attention_layer"
    loc = f"{att}.location_layer"
    for name in (f"{att}.query_layer", f"{att}.memory_layer", f"{att}.v",
                 f"{loc}.location_dense"):
        t2[f"{name}.linear_layer.weight"] = torch.zeros_like(
            t2[f"{name}.linear_layer.weight"])
    conv = torch.zeros_like(t2[f"{loc}.location_conv.conv.weight"])
    mid = (conv.shape[-1] - 1) // 2                     # reads position j
    conv[0, 0, mid], conv[0, 0, mid - 1] = spec["b"], spec["a"]
    conv[0, 1, mid] = -spec["c"]
    conv[1, 0, mid - 1] = conv[1, 0, mid] = spec["alpha"]
    t2[f"{loc}.location_conv.conv.weight"] = conv
    dense = t2[f"{loc}.location_dense.linear_layer.weight"]
    dense[0, 0] = dense[1, 1] = 1.0
    memory = t2[f"{att}.memory_layer.linear_layer.weight"]
    memory[1, k] = -spec["beta"] / constant
    memory[2, u] = -spec["s"]
    t2[f"{att}.v.linear_layer.weight"][0, :3] = torch.tensor(
        [spec["kA"], spec["kB"], spec["kC"]])
    gate = "decoder.gate_layer.linear_layer.weight"
    t2[gate] = t2[gate].clone()
    memory_start = cfg["decoder_rnn_dim"]       # [dec_h, memory, speaker]
    t2[gate][0, :memory_start + cfg["encoder_embedding_dim"]] = 0.0
    t2[gate][0, memory_start + u] = spec["gate_position"]


def write_checkpoints(config: dict, weights: dict,
                      workdir: pathlib.Path) -> dict:
    workdir.mkdir(parents=True, exist_ok=True)
    paths = {"checkpoint": workdir / "tacotron2.pth",
             "vocoder_sd": workdir / "hifigan.pth",
             "vocoder_config": workdir / "hifigan.json"}
    torch.save({"model": weights["tacotron2"],
                "config": config["tacotron2"]}, paths["checkpoint"])
    torch.save({"generator": weights["hifigan"]}, paths["vocoder_sd"])
    paths["vocoder_config"].write_text(json.dumps(config["hifigan"]))
    return {k: str(v) for k, v in paths.items()}


def pipeline(config: dict, paths: dict, device, quantize=None):
    """The port's `Tacotron2Wave` on the benchmark's checkpoints, its step
    cap the configuration's."""
    from tts_arabic_torch.infer import Tacotron2Wave
    from tts_arabic_torch.models.tacotron2 import Tacotron2Config
    pipe = Tacotron2Wave(
        model_sd_path=paths["checkpoint"], vocoder_sd=paths["vocoder_sd"],
        vocoder_config=paths["vocoder_config"],
        config=Tacotron2Config(**config["tacotron2"]),
        compute_dtype=FP._DTYPES[config["compute_dtype"]], arabic_in=False,
        quantize=quantize, device=device)
    pipe.model.decoder_max_step = config["tacotron2"]["decoder_max_step"]
    return pipe


class Capture:
    """Records, from outside, each batch's decode (its padded token ids
    and speakers on the host; the mel, the postnet's mel, the gate logits
    and the lengths, device tensors held, not copied), the mel bucket of
    each batch's vocoder call, and each denoiser call's input and
    output."""

    def __init__(self):
        self._decodes, self._buckets, self._denoised = [], [], []

    @contextlib.contextmanager
    def installed(self):
        from tts_arabic_torch.infer.tacotron_pipeline import (Tacotron2TTS,
                                                              Tacotron2Wave)
        from tts_arabic_torch.vocoder import denoiser
        cap = self
        patches = []
        infer_fn = getattr(Tacotron2TTS, "_infer", None)
        assemble_fn = getattr(Tacotron2Wave, "_assemble_fn", None)
        denoise_fn = getattr(denoiser, "denoise", None)

        def infer(self, padded, lens, speakers, *a, **kw):
            out = infer_fn(self, padded, lens, speakers, *a, **kw)
            cap._decodes.append({
                "ids": np.asarray(padded, np.int64).copy(),
                "lens": np.asarray(lens, np.int64).copy(),
                "speakers": np.asarray(speakers, np.int64).copy(),
                **{k: out[k] for k in ("mel", "mel_postnet", "gates",
                                       "alignments", "mel_lens")}})
            return out

        def assemble(*a, **kw):
            cap._buckets.append(kw.get("bucket"))
            return assemble_fn(*a, **kw)

        def denoise(audio, *a, **kw):
            out = denoise_fn(audio, *a, **kw)
            cap._denoised.append((audio, out))
            return out

        if infer_fn is not None:
            patches.append(mock.patch.object(Tacotron2TTS, "_infer", infer))
        if assemble_fn is not None:
            patches.append(mock.patch.object(Tacotron2Wave, "_assemble_fn",
                                             staticmethod(assemble)))
        if denoise_fn is not None:
            patches.append(mock.patch.object(denoiser, "denoise", denoise))
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            yield self

    def take(self):
        """The records since the last take, still on the device. A batch's
        bucket is its vocoder call's, the calls paired with the decodes in
        order (None where their counts differ)."""
        decodes, buckets = self._decodes, self._buckets
        denoised = self._denoised
        self._decodes, self._buckets, self._denoised = [], [], []
        if len(buckets) != len(decodes):
            buckets = [None] * len(decodes)
        rows = {}
        for dec, bucket in zip(decodes, buckets):
            for r, n in enumerate(dec["lens"]):
                rows[FP.key(dec["ids"][r, :n])] = (dec, r, bucket)
        return FP.Records(rows, denoised)


def target_frames(gate: dict, n_tokens: int, cap: int) -> int:
    """The stop gate control is given for a row of `n_tokens` tokens: the
    configuration's frames a token, clipped to [min_len, cap - 16], as
    `install_gate_control` computes its default targets."""
    want = int(gate["frames_per_token"] * n_tokens)
    return int(np.clip(want, gate["min_len"], cap - 16))


def gate_wrong_side(gate: torch.Tensor, length: int, cap: int,
                    threshold: float) -> float:
    """How far (logits) the gate logits [L] of a row that stopped after
    `length` steps lie on the wrong side of the threshold: above it before
    the stop step, or not above it at the stop step (unless the row ran to
    the cap). 0 where every step lies on its side."""
    theta = math.log(threshold / (1.0 - threshold))
    z = gate.double() - theta
    before = z[: length - 1] if length < cap else z[:length]
    worst = float(before.max().clamp_min(0.0)) if len(before) else 0.0
    if length < cap:
        worst = max(worst, float(-z[length - 1].clamp_max(0.0)))
    return worst


def rewired_leaves(state: dict, seeded: dict) -> int:
    """State-dict leaves, other than REWIRED, that are not bit-equal to the
    benchmark's seeded ones (or that one side lacks)."""
    names = (set(state) | set(seeded)) - set(REWIRED)
    return sum(1 for n in names
               if n not in state or n not in seeded
               or not torch.equal(state[n].cpu(), seeded[n].cpu()))


class Reference:
    """The plain reference on the program's Tacotron2 state and the
    benchmark's HiFi-GAN weights, in float32 with TF32 off."""

    def __init__(self, config: dict, t2_state: dict, hg_weights: dict,
                 device):
        self.cfg, self.h = config["tacotron2"], config["hifigan"]
        self.t2 = {k: v.to(device).float() for k, v in t2_state.items()
                   if v.is_floating_point()}
        self.hg = {k: v.to(device) for k, v in hg_weights.items()}
        self.device = device
        self.hop = ref_hg.hop_length(self.h)
        self._masks = {}
        with FP.precision(False):
            self.bias = ref_hg.bias_spectrum(self.hg, self.h)

    def masks(self, batch: int) -> torch.Tensor:
        if batch not in self._masks:
            self._masks[batch] = ref_t2.prenet_masks(
                self.cfg, self.cfg["decoder_max_step"], batch, self.device)
        return self._masks[batch]

    def teacher_forced(self, ids, speaker: int, row: int, batch: int,
                       frames: torch.Tensor, align: torch.Tensor) -> dict:
        """The reference's decode of one utterance fed the program's
        frames [L, n_mels] and attention weights [L, T] (row `row` of a
        batch of `batch` rows) -> {"mel_postnet" [L, n_mels], "gate"
        [L]}."""
        with FP.precision(False):
            enc = ref_t2.encode(self.t2, self.cfg, ids, speaker)
            got = ref_t2.decode(self.t2, self.cfg, enc,
                                self.masks(batch)[:, :, row],
                                frames=frames.to(self.device).float(),
                                align=align.to(self.device).float())
            return {"mel_postnet": ref_t2.postnet(self.t2, self.cfg,
                                                  got["mel"]),
                    "gate": got["gate"]}

    def denoise(self, wave: torch.Tensor, strength: float) -> torch.Tensor:
        with FP.precision(False):
            return ref_hg.denoise(wave.float(), self.bias, strength)

    def wave(self, mel: torch.Tensor, pad_to: int,
             denoise: float) -> np.ndarray:
        """The reference vocoder and denoiser on a mel [L, n_mels] padded
        with silence to `pad_to` frames, as the pipeline pads a batch to
        its bucket: the mel's own samples."""
        with FP.precision(False):
            mel = mel.to(self.device).float()
            pad = torch.full((max(pad_to - mel.shape[0], 0), mel.shape[1]),
                             LOG_MEL_PAD, device=mel.device)
            wave = ref_hg.generate(self.hg, self.h, torch.cat([mel, pad]))
            if denoise > 0:
                wave = ref_hg.denoise(wave, self.bias, denoise)
            return wave[: mel.shape[0] * self.hop].cpu().numpy()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def check(samples: list, denoised: list, reference: Reference,
          config: dict, denoise: float) -> dict:
    """The numbers that decide `correct` (but `rewired_leaves`, which the
    program's state gives), over the sampled utterances [(text, wave in
    [-1, 1], Records of its call)] and the denoiser calls of the sampled
    calls [(input, output)]:

    - tokens_mismatched: utterances whose token ids the program's timed
      path did not decode as the reference's frontend gives them (or of
      which it left no record);
    - stops_mismatched: utterances whose wave is not hop x the decode's
      length (`mel_lens`) long;
    - stops_off_target: utterances whose decode ran to the cap, stopped
      under `min_len`, or more than `off_target` from gate control's
      target (`target_frames`);
    - mel_rel_err: the largest ||postnet mel - reference|| /
      ||reference|| of an utterance over its length, the reference
      teacher-forced on the program's frames;
    - gate_margin: the largest `gate_wrong_side` of the reference's gate
      logits against the program's stop;
    - wave_rel_err: the largest ||wave - reference|| / ||reference|| of an
      utterance, the reference vocoding the program's postnet mel at the
      batch's bucket, then denoising;
    - denoise_rel_err: as `fastpitch_hifigan.check` reads it."""
    cfg, gate = config["tacotron2"], config["gate_control"]
    cap = cfg["decoder_max_step"]
    out = {"tokens_mismatched": 0, "stops_mismatched": 0,
           "stops_off_target": 0, "mel_rel_err": 0.0, "gate_margin": 0.0,
           "wave_rel_err": 0.0, "denoise_rel_err": 0.0}
    for text, wave, records in samples:
        ids = ref_t2.ids(text)
        if FP.key(ids) not in records.rows:
            out["tokens_mismatched"] += 1
            continue
        dec, r, bucket = records.rows[FP.key(ids)]
        length = int(dec["mel_lens"][r])
        if len(wave) != length * reference.hop:
            out["stops_mismatched"] += 1
            continue
        target = target_frames(gate, len(ids), cap)
        if (length >= cap or length < gate["min_len"]
                or abs(length - target) > gate["off_target"] * target):
            out["stops_off_target"] += 1
        post = dec["mel_postnet"][r, :length]
        ref = reference.teacher_forced(
            ids, int(dec["speakers"][r]), r, len(dec["lens"]),
            dec["mel"][r, :length],
            dec["alignments"][r, :length, :len(ids)])
        out["mel_rel_err"] = max(out["mel_rel_err"],
                                 _rel(post, ref["mel_postnet"]))
        out["gate_margin"] = max(out["gate_margin"], gate_wrong_side(
            ref["gate"], length, cap, cfg["gate_threshold"]))
        pad_to = bucket if bucket is not None else (
            length + FALLBACK_PAD_FRAMES)
        want = reference.wave(post, pad_to, denoise)
        err = np.linalg.norm(wave - want) / max(np.linalg.norm(want), 1e-30)
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
    """Model FLOPs of one utterance at its own tokens and frames (the
    benchmark's frozen counts): Tacotron2's decode at its own steps, one a
    frame (the steps its batch ran past its stop are the stopped rows'
    waste, `stopped_row_share.tacotron`), and HiFi-GAN on its frames."""
    return (yardstick_tacotron2.tacotron2_flops(config["tacotron2"],
                                                n_tokens, n_frames)
            + n_frames * yardstick.generator_flops_per_frame(
                config["hifigan"]))


# ---- the program as a driver sees it ---------------------------------------------

class Program:
    """The program of one run: the port's pipeline on the benchmark's
    seeded weights, rewired by gate control at set-up. `quantize="int8"`
    switches on the program's own int8 vocoder (a control)."""

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
            FP.remove_checkpoints(paths)
        self.setup_spans["program built"] = time.perf_counter() - t
        self.capture = Capture()
        self.vocoder = self.pipe.vocoder
        self.hop = self.pipe.hop_length
        self.sample_rate = self.pipe.sample_rate
        self.dtype = self.config["compute_dtype"]
        self.speakers, self.report, self.state = {}, None, None
        self._n_tokens = {}

    def warm(self, calls) -> None:
        """Set-up: the decode-block graphs of the call's shape (with early
        stopping, and without it for gate control's probes), gate control
        on the call's texts in the order they come, then the call once."""
        from tts_arabic_torch.eval.gate_control import install_gate_control
        from tts_arabic_torch.infer.pipeline import TEXT_BUCKET
        bs = self.mix["batch_size"]
        if len(calls) != 1 or len(calls[0]) != bs:
            raise ValueError("gate control calibrates one batch: the mix "
                             f"sends one call of {bs} prompts")
        texts = calls[0]
        m = self.pipe.model
        t = time.perf_counter()
        n = max(len(m.tokenize(x)) for x in texts)
        shape = ((bs,), (-(-n // TEXT_BUCKET) * TEXT_BUCKET,))
        m.capture_graphs(*shape)
        net = m.model
        cfg = net.config
        net.config = dataclasses.replace(cfg, decoder_early_stopping=False)
        try:
            m.capture_graphs(*shape)
        finally:
            net.config = cfg
        self.setup_spans["graphs captured"] = time.perf_counter() - t
        t = time.perf_counter()
        gate = self.config["gate_control"]
        cap = self.config["tacotron2"]["decoder_max_step"]
        targets = [target_frames(gate, self.n_tokens(x), cap) for x in texts]
        speakers, _, self.report = install_gate_control(
            self.pipe, texts, targets, min_len=gate["min_len"],
            use_cache=False)
        self.speakers = {x: int(s) for x, s in zip(texts, speakers)}
        self.setup_spans["gate control"] = time.perf_counter() - t
        t = time.perf_counter()
        self.call(texts)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_spans["warm-up"] = time.perf_counter() - t

    def call(self, texts: list) -> list:
        return self.pipe.tts(texts, batch_size=self.mix["batch_size"],
                             speaker_id=[self.speakers[x] for x in texts],
                             postprocess_mel=False,
                             denoise=self.mix["denoise"])

    def generator_calls(self):
        return FP.generator_calls(self.vocoder)

    def free(self) -> None:
        """Keep the program's Tacotron2 state (on the host), then drop the
        program before the reference runs."""
        if self.pipe is not None:
            self.state = {k: v.detach().cpu().clone() for k, v in
                          self.pipe.model.model.state_dict().items()}
        self.pipe = self.vocoder = None
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, samples: list, denoised: list) -> dict:
        """`check` of the sampled requests [(text, wave, Records)] and
        denoiser calls against a Reference made now on the program's
        state (call after `free`), and `rewired_leaves`."""
        ref = Reference(self.config, self.state, self.weights["hifigan"],
                        self.device)
        numbers = check([(t, np.asarray(w, np.float32), r)
                         for t, w, r in samples], denoised, ref,
                        self.config, self.mix["denoise"])
        numbers["rewired_leaves"] = rewired_leaves(
            self.state, self.weights["tacotron2"])
        return numbers

    def n_tokens(self, text: str) -> int:
        if text not in self._n_tokens:
            self._n_tokens[text] = len(ref_t2.ids(text))
        return self._n_tokens[text]

    def flops(self, text: str, n_samples: int) -> int:
        return utterance_flops(self.config, self.n_tokens(text),
                               n_samples // self.hop)

    def describe(self, served: list) -> str:
        """A line on the work the window served and on set-up."""
        tokens = sum(self.n_tokens(t) for t, _ in served)
        frames = sum(n for _, n in served) // self.hop
        rep = self.report or {}
        return (f"served {len(served)} utterances, {tokens} tokens, "
                f"{frames} frames ({frames / max(tokens, 1):.3f} a token) | "
                f"gate control: off target {rep.get('off_target')}, fired "
                f"{rep.get('n_fired')}, lengths "
                f"{rep.get('realized_lengths')} | set-up: "
                + ", ".join(f"{k} {v:.2f} s" for k, v in
                            self.setup_spans.items()))
