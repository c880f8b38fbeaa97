"""High-level TTS inference pipelines (torch counterpart of the JAX
package's `infer/pipeline.py`): `FastPitchTTS.ttmel()`,
`FastPitch2Wave.tts()` and `FastPitch2Wave.stream()`, accepting Arabic
script or Buckwalter, str or list, optionally vowelized first by a
diacritizer (`vowelizer="shakkala"` or `"shakkelha"`).

Execution model, as in the JAX package:

1. tokenize on the host; sort by length; cut into batches
2. pad token ids to a TEXT bucket (multiple of 16) and batch rows to the
   batch size -> encode in float32 (durations decide output lengths)
3. one scalar fetch per batch: the predicted mel lengths pick a MEL bucket
4. length-regulate + decoder + mel projection at that bucket, then HiFi-GAN
   and the spectral denoiser, in `compute_dtype` (the denoiser in f32)
5. crop to the true lengths, unsort, return numpy

The bucket padding is kept exactly: the vocoder's receptive field and the
denoiser's reflect pad see the LOG_MEL_PAD frames past each utterance, so
tail samples depend on it.

`stream()` decodes the whole mel once and vocodes it window by window
(overlap-discard), so the first audio is ready after one window.

`FastPitch2Wave(vocoder_type="vocos")` vocodes with Vocos (its denoising
in the head); `quantize="int8"` / `calibrate_int8()` run the HiFi-GAN
MRF stages of >= 64 channels and the decoder FFN in static-scale int8
(`ops.hifigan_int8`, `models.layers.ConvFFN`).

On the card a one-row batch (`tts_single`, `stream`, `tts` at batch size
1) pads its tokens to a GRAPH_TEXT_BUCKETS length, and its encode and
decoder replay the CUDA graphs that `capture_graphs()` (run by
`FastPitch2Wave.warmup`) recorded: at batch 1 their time is the host's
dispatch of some 400 ops, and a replay is one.

Entry points run on the card: `device=None` means "cuda" and raises when
there is no CUDA device; pass `device="cpu"` to run on the CPU.

Data parallelism (`mesh=`, a `parallel.make_mesh()` over the ranks of a
`torch.distributed` world, one process a rank, each on its own device):
every rank makes the same call with the same texts. A batch's rows are
padded up to a multiple of the mesh's data axis, as the JAX package pads
them; each rank encodes, decodes and vocodes its contiguous rows; the mel
bucket is the batch's over every rank (one max all-reduce), as JAX's one
global program picks it; and the waves are gathered, so every rank
returns the whole batch in text order. `stream()` and the int8
calibration run whole on every rank.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import text as text_frontend
from ..audio.io import mulaw_encode
from ..models.convert import fold_weight_norm, load_reference_pth, to_tensors
from ..models.fastpitch import FastPitch, FastPitchConfig, regulate_len
from ..models.layers import init_weights
from ..parallel.mesh import (DATA_AXIS, all_gather, all_reduce,
                             process_local_rows, replicate)
from ..runtime.checkpoint import load_states
from ..runtime.config import get_basic_config
from ..runtime.device import resolve_device
from ..runtime.profiling import count, enabled, span
from ..vocoder import denoiser as denoiser_mod
from ..vocoder.hifigan import Generator, HiFiGANConfig, chunked_vocode

LOG_MEL_PAD = float(np.log(1e-5))  # log-mel floor = silence padding value

TEXT_BUCKET = 16
MEL_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072)

# one-row batches on the card pad their tokens to the first of these that
# holds them (longer ones to a multiple of TEXT_BUCKET), so that their
# encode replays a graph captured at that length
GRAPH_TEXT_BUCKETS = (16, 32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536,
                      2048)

# stream() decodes at this many frames' bucket before it knows the
# utterance's length, and vocodes its first window from that mel while the
# host waits for the length (about 24 s of speech); a longer utterance
# decodes again at its own bucket
STREAM_SPEC_FRAMES = 2048


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _pick_mel_bucket(n: int) -> int:
    for b in MEL_BUCKETS:
        if n <= b:
            return b
    return _round_up(n, 1024)


def _default_vocoder_paths(vocoder_sd, vocoder_config, enabled=True):
    """With no vocoder weights given, the basic config's
    `vocoder_state_path` / `vocoder_config_path` when those files exist,
    as the reference wrappers load their vocoder (configs/basic.yaml,
    `models/fastpitch/networks.py:262-276`). `enabled` is False for a
    seeded pipeline (no acoustic checkpoint), whose results must not
    depend on what lies in pretrained/."""
    if vocoder_sd is not None or not enabled:
        return vocoder_sd, vocoder_config
    basic = get_basic_config()
    path = basic.get_path("vocoder_state_path")
    if path.is_file():
        vocoder_sd = str(path)
        if vocoder_config is None:
            cfg = basic.get_path("vocoder_config_path")
            vocoder_config = str(cfg) if cfg.is_file() else None
    return vocoder_sd, vocoder_config


def _pad_ids(ids_list: Sequence[np.ndarray], length: int) -> np.ndarray:
    out = np.zeros((len(ids_list), length), np.int64)
    for i, ids in enumerate(ids_list):
        out[i, : len(ids)] = ids
    return out


def _output(wave: torch.Tensor, out_int16) -> torch.Tensor:
    """f32 wave -> the requested output on the device: f32 (False), int16
    (True) or mu-law uint8 codes ("mulaw")."""
    if out_int16 == "mulaw":
        return mulaw_encode(wave)
    if out_int16:
        return (torch.clamp(wave, -1.0, 1.0) * 32767.0).to(torch.int16)
    return wave


@contextlib.contextmanager
def _exact_f32():
    """float32 matmuls and convolutions in full float32: cuDNN's default
    TF32 would perturb predicted durations (and so output lengths), as the
    TPU's default bf16 passes do for the JAX package."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


class FastPitchTTS:
    """Text -> mel pipeline (reference `FastPitch` wrapper equivalent).

    checkpoint: a reference `.pth` (read with `weights_only=True`), the
    port's own training checkpoint (`states.ckpt` of
    `apps.train_fastpitch`), or None for seeded random weights (tests and
    benchmarks)."""

    def __init__(self, checkpoint=None, config: FastPitchConfig | None = None,
                 arabic_in: bool = True, vowelizer: Optional[str] = None,
                 seed: int = 0, strict_text: bool = False, device=None,
                 mesh=None):
        """strict_text: False (default) drops tokens outside the symbol
        table (trailing punctuation); True raises the reference's KeyError
        on them. vowelizer: the default diacritizer of every call
        ("shakkala", "shakkelha" or None). mesh: a data-parallel mesh
        (see the module docstring); the weights are replicated from its
        first rank."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.arabic_in = arabic_in
        self.strict_text = strict_text
        self.default_vowelizer = vowelizer
        self._vowelizers = {}
        self._graphs = {}       # see capture_graphs
        self.graph_replays = 0
        self.phon_to_id = None
        sd = None
        if checkpoint is not None:
            sd, config = self._load_checkpoint(checkpoint, config)
        self.config = config or FastPitchConfig()
        self.model = FastPitch(self.config)
        if sd is None:
            init_weights(self.model, seed)
        else:
            self.model.load_state_dict(to_tensors(sd), strict=True)
        self.model.to(self.device).eval()
        if mesh is not None:
            replicate(self.model, mesh)

    def _load_checkpoint(self, checkpoint, config):
        """(state dict, config) from a reference `.pth`/`.pt` or from a
        training checkpoint, whose config holds the reference-style
        `net_config` the trainer wrote."""
        path = str(checkpoint)
        if path.endswith((".pth", ".pt")):
            sd, extras = load_reference_pth(path)
            if config is None and extras.get("config"):
                config = FastPitchConfig.from_reference_net_config(
                    extras["config"])
            if "symbols" in extras:
                self.phon_to_id = {p: i for i, p in
                                   enumerate(extras["symbols"])}
            return sd, config
        state = load_states(path)
        if config is None:
            net_config = (state.get("config") or {}).get("net_config")
            config = (FastPitchConfig.from_reference_net_config(net_config)
                      if net_config else FastPitchConfig())
        return state["model"], config

    # -- text frontend -------------------------------------------------------

    def _vowelizer(self, vowelizer: Optional[str]):
        """The diacritizer named by the call or the default, loaded once;
        None when neither names one."""
        name = vowelizer or self.default_vowelizer
        if name is None:
            return None
        if name not in self._vowelizers:
            from ..diacritizers import load_vowelizer
            self._vowelizers[name] = load_vowelizer(name, device=self.device)
        return self._vowelizers[name]

    def _ids(self, utterance: str) -> np.ndarray:
        to_tokens = (text_frontend.arabic_to_tokens if self.arabic_in
                     else text_frontend.buckwalter_to_tokens)
        ids = text_frontend.tokens_to_ids(
            to_tokens(utterance, append_space=False), self.phon_to_id,
            strict=self.strict_text)
        return np.asarray(ids, np.int64)

    def tokenize(self, utterance: str,
                 vowelizer: Optional[str] = None) -> np.ndarray:
        """Token ids of one utterance; with a vowelizer, the utterance is
        read as Buckwalter or Arabic script, turned into Arabic script and
        vowelized first (JAX `_vowelize`)."""
        model = self._vowelizer(vowelizer)
        if model is not None:
            utterance = model.predict(
                text_frontend.buckwalter_to_arabic(utterance))
        return self._ids(utterance)

    def tokenize_batch(self, batch: List[str],
                       vowelizer: Optional[str] = None) -> List[np.ndarray]:
        """tokenize() of each utterance, with one batched diacritizer
        forward for the whole batch."""
        model = self._vowelizer(vowelizer)
        if model is None:
            return [self._ids(t) for t in batch]
        vowelized = model.predict(
            [text_frontend.buckwalter_to_arabic(t) for t in batch])
        return [self._ids(v) for v in vowelized]

    # -- phases --------------------------------------------------------------

    def _encode_fn(self, tokens, pitch_mul, pitch_add, speaker, pace=1.0, *,
                   max_duration=75.0):
        """Encode in float32; dec_lens / dec_len_max are computed on the
        device with regulate_len's rounding, so the host fetches one
        scalar to pick the mel bucket."""
        enc = self.model.encode_infer(tokens, speaker=speaker,
                                      pitch_mul=pitch_mul,
                                      pitch_add=pitch_add,
                                      max_duration=max_duration)
        reps = torch.floor(enc["dur_pred"] / pace + 0.5)
        enc["dec_lens"] = reps.sum(dim=1).to(torch.int32)
        enc["dec_len_max"] = enc["dec_lens"].max()
        return enc

    def _decoder_fn(self, regulated, mel_lens, ffn_scales=None):
        """Decoder + projection in regulated's dtype; padding frames are set
        to the log-mel silence floor so the vocoder sees silence, not
        decoder noise. ffn_scales: the decoder ConvFFNs' int8 input scales
        (one f32 [2] device tensor a layer), for this call only."""
        decoder = self.model.decoder
        decoder.set_ffn_int8(ffn_scales)
        try:
            mel = self.model.decode_regulated(regulated, mel_lens)
        finally:
            decoder.set_ffn_int8(None)
        frame_ids = torch.arange(mel.shape[1], device=mel.device)[None, :,
                                                                 None]
        return torch.where(frame_ids < mel_lens[:, None, None], mel,
                           LOG_MEL_PAD)

    def _decode_fn(self, enc_out, durations, pace, *, max_frames,
                   ffn_scales=None):
        """Length-regulate to max_frames, then decode in enc_out's dtype
        (the decoder FFN in int8 with `ffn_scales`)."""
        regulated, mel_lens = regulate_len(durations, enc_out, max_frames,
                                           pace)
        mel = self._graphed(self._decode_key(regulated, ffn_scales),
                            functools.partial(self._decoder_fn,
                                              ffn_scales=ffn_scales),
                            regulated, mel_lens)
        return mel, mel_lens

    @staticmethod
    def _decode_key(regulated, ffn_scales) -> tuple:
        """The graph key of a decode: shape, dtype, float or int8 FFN."""
        return ("decode", tuple(regulated.shape), regulated.dtype,
                ffn_scales is not None)

    # -- CUDA graphs of the one-row encode and decoder -----------------------

    def _graphed(self, key, fn, *inputs):
        """fn(*inputs), replayed from the CUDA graph that capture_graphs()
        recorded under `key` when there is one (tensor inputs are copied
        into the graph's own, python scalars filled into its device
        scalars), else run as it is. A replay returns copies of the
        graph's outputs, which its next replay overwrites."""
        entry = self._graphs.get(key)
        if entry is None:
            return fn(*inputs)
        graph, static, out = entry
        for dst, src in zip(static, inputs):
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                dst.fill_(src)
        graph.replay()
        self.graph_replays += 1
        if isinstance(out, dict):
            return {k: v if v is None else v.clone() for k, v in out.items()}
        return out.clone()

    def _capture(self, key, fn, *static, pool):
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):   # library handles, workspaces
            fn(*static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            out = fn(*static)
        self._graphs[key] = (graph, static, out)

    def capture_graphs(self, dtype: torch.dtype | None = None,
                       ffn_scales=None) -> None:
        """Record CUDA graphs of the one-row encode at every
        GRAPH_TEXT_BUCKETS length and of the decoder at every MEL_BUCKETS
        length in `dtype` (float32 when None; the decode dtype of the
        caller), its FFN in int8 with `ffn_scales` (the graphs read those
        tensors, which must outlive them). Every later one-row encode and
        decode at those lengths, in that mode, replays them, whatever its
        text, speed, pitch and speaker; nothing is captured on a request's
        path, and a longer one runs eagerly. Does nothing off the card.

        The graphs share one memory pool: a graph's intermediates may lie
        where another's outputs do, which is safe because `_graphed` copies
        the outputs before the next replay. So a pipeline serves one call
        at a time (the server runs every synthesis on one worker thread)."""
        if self.device.type != "cuda":
            return
        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        dtype = dtype or torch.float32
        d_model = self.config.d_model

        def scalar(value, kind=torch.float32):
            return torch.full((), value, dtype=kind, device=dev)

        with _exact_f32():
            for n in GRAPH_TEXT_BUCKETS:
                tokens = torch.ones((1, n), dtype=torch.long, device=dev)
                self._capture(("encode", (1, n)), self._encode_fn, tokens,
                              scalar(1.0), scalar(0.0),
                              scalar(0, torch.long), scalar(1.0), pool=pool)
            for frames in MEL_BUCKETS:
                regulated = torch.zeros((1, frames, d_model), dtype=dtype,
                                        device=dev)
                self._capture(
                    self._decode_key(regulated, ffn_scales),
                    functools.partial(self._decoder_fn,
                                      ffn_scales=ffn_scales),
                    regulated,
                    torch.full((1,), frames, dtype=torch.int32, device=dev),
                    pool=pool)

    def _text_length(self, n: int, rows: int) -> int:
        """The padded token length of a batch of `rows` rows whose longest
        has n tokens."""
        if rows == 1 and self.device.type == "cuda":
            for length in GRAPH_TEXT_BUCKETS:
                if n <= length:
                    return length
        return _round_up(max(n, 1), TEXT_BUCKET)

    def _sharded(self, shard: bool) -> bool:
        return shard and self.mesh is not None

    def _global_max(self, x: torch.Tensor) -> list:
        """x's values as ints, each the max over the mesh's ranks."""
        if self.mesh is not None:
            x = all_reduce(x, self.mesh, DATA_AXIS, op="max")
        return x.tolist()

    def _gather(self, x):
        """Every rank's rows of x, in rank order (None stays None)."""
        return None if x is None else all_gather(x, self.mesh, DATA_AXIS)

    def _encode_batch(self, ids_list, speaker_id, pitch_mul, pitch_add,
                      pad_to=None, speed=1.0, shard=False):
        """Sort + pad + encode; returns (enc, inverse order, n_real). Batch
        rows are padded to `pad_to` with one-pad-token rows. With `shard`
        and a mesh, the rows are padded up to a multiple of its data axis
        and this rank encodes its own (inverse and n_real stay global)."""
        n_real = len(ids_list)
        lens = np.asarray([len(x) for x in ids_list])
        order = np.argsort(-lens)
        ids_sorted = [ids_list[i] for i in order]
        rows = pad_to if pad_to is not None else n_real
        if self._sharded(shard):     # the batch axis must divide the mesh
            rows += (-rows) % self.mesh.axis_size(DATA_AXIS)
        if n_real < rows:
            ids_sorted += [np.zeros(1, np.int64)] * (rows - n_real)
        tokens = _pad_ids(ids_sorted,
                          self._text_length(int(lens.max()), len(ids_sorted)))
        if self._sharded(shard):
            tokens = tokens[process_local_rows(len(tokens), self.mesh)]
        tokens = torch.from_numpy(tokens).to(self.device)
        with _exact_f32():
            enc = self._graphed(("encode", tuple(tokens.shape)),
                                self._encode_fn, tokens, float(pitch_mul),
                                float(pitch_add), int(speaker_id),
                                float(speed))
        return enc, np.argsort(order), n_real

    def _infer_batch_mel(self, ids_list, speed, speaker_id, pitch_mul,
                         pitch_add, pad_to=None, shard=False):
        enc, inverse, _ = self._encode_batch(ids_list, speaker_id, pitch_mul,
                                             pitch_add, pad_to, speed, shard)
        if self._sharded(shard):
            bucket = _pick_mel_bucket(self._global_max(enc["dec_len_max"]))
        else:
            bucket = _pick_mel_bucket(int(enc["dec_len_max"]))
        with _exact_f32():
            mel, mel_lens = self._decode_fn(enc["enc_out"], enc["dur_pred"],
                                            float(speed), max_frames=bucket)
        if self._sharded(shard):
            mel, mel_lens = self._gather(mel), self._gather(mel_lens)
        return mel, mel_lens, inverse, bucket

    # -- public API ----------------------------------------------------------

    def ttmel_batch(self, batch: List[str], speed: float = 1.0,
                    speaker_id: int = 0, vowelizer: Optional[str] = None,
                    pitch_mul: float = 1.0, pitch_add: float = 0.0,
                    pad_to=None):
        mel, mel_lens, inverse, _ = self._infer_batch_mel(
            self.tokenize_batch(batch, vowelizer), speed, speaker_id,
            pitch_mul, pitch_add, pad_to, shard=True)
        mel = mel.float().cpu().numpy()
        mel_lens = mel_lens.cpu().numpy()
        return [mel[i, : mel_lens[i]].T for i in inverse]  # [80, T] each

    def ttmel_single(self, utterance: str, **kw):
        return self.ttmel_batch([utterance], **kw)[0]

    def ttmel(self, text_input: Union[str, List[str]], speed: float = 1.0,
              speaker_id: int = 0, batch_size: int = 1,
              vowelizer: Optional[str] = None, pitch_mul: float = 1.0,
              pitch_add: float = 0.0):
        kw = dict(speed=speed, speaker_id=speaker_id, vowelizer=vowelizer,
                  pitch_mul=pitch_mul, pitch_add=pitch_add)
        if isinstance(text_input, str):
            return self.ttmel_single(text_input, **kw)
        order = sorted(range(len(text_input)),
                       key=lambda i: -len(text_input[i]))
        bs = max(batch_size, 1)
        out = [None] * len(text_input)
        for k in range(0, len(order), bs):
            idxs = order[k: k + bs]
            mels = self.ttmel_batch([text_input[i] for i in idxs],
                                    pad_to=bs, **kw)
            for i, m in zip(idxs, mels):
                out[i] = m
        return out


# the default int8 calibration texts (ASC corpus sentences, long and
# phoneme-diverse so that the MRF activations span their serving range;
# the same sentences in both input modes, as the JAX package's:
# data/test_arab.txt line 1, data/infer_test.txt lines 1-3)
_INT8_CALIB_ARABIC = [
    "أَتاحَت لِلبائِعِ لمُتَجَوِّلِ أَن يَكُونَ جاذِبَن لِلمُواطِنِ لأَقَلِّ دَخلَن",
    "أَحرَزَت مُنتَخَباتُ لبَرازِيلِ وَألمانيا وَرُوسيا فَوزَن فِي مُقابَلاتِهِم"
    " لإِعدادِيَّةِ لَّتِي أُقِيمَت ِستِعدادَن لِنِهائِيّاتِ كَأسِ لعالَم",
    "إِذ سَيَحضُرُ لِقاءَ هَذا لعامِ خَمسُن وَثَلاثُونَ مِنهُم",
]
_INT8_CALIB_BUCKWALTER = [
    ">atAHat lilbA}iEi lmutajaw~ili >an yakuwna jA*iban lilmuwATini"
    " l>aqal~i daxlan",
    ">aHrazat muntaxabAtu lbarAziyli wa>lmAnyA waruwsyA fawzan fiy"
    " muqAbalAtihim l<iEdAdiy~api",
    "<i* sayaHDuru liqAa ha*A lEAmi xamsun wa^alA^uwna minhum",
]


def _check_quantize(quantize) -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; "
                         "supported: 'int8'")


def _calibration_texts(texts, arabic_in: bool) -> list:
    return list(texts or (_INT8_CALIB_ARABIC if arabic_in
                          else _INT8_CALIB_BUCKWALTER))


class FastPitch2Wave:
    """End-to-end text -> waveform (reference `FastPitch2Wave` equivalent):
    FastPitch, HiFi-GAN (or Vocos) and the spectral denoiser."""

    def __init__(self, model_sd_path=None, vocoder_sd=None,
                 vocoder_config=None, vowelizer: Optional[str] = None,
                 arabic_in: bool = True, config=None, seed: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 strict_text: bool = False, device=None,
                 vocoder_type: str = "hifigan",
                 quantize: Optional[str] = None, mesh=None):
        """compute_dtype: torch.bfloat16 runs the decoder and the vocoder in
        bf16 (weights stay f32 in memory and are cast per call); encode and
        the denoiser stay f32. None = f32 throughout.

        vocoder_sd: a reference HiFi-GAN `.pth` (weight norm is folded at
        load); None takes the basic config's vocoder when an acoustic
        checkpoint is given and that file exists, else seeded random
        weights (seed + 1).

        vocoder_type: "hifigan" (default) or "vocos": `MelVocosModule` with
        CONFIG_22K, from a reference Vocos `.pth` (vocoder_sd) or seeded
        (seed + 1), its denoising fused into its head (JAX
        `infer/pipeline.py:427-448`).

        quantize: None or "int8": the static-calibrated int8 HiFi-GAN MRF
        stages and decoder FFN (`calibrate_int8`), calibrated in this
        constructor on the built-in texts.

        mesh: a data-parallel mesh (see the module docstring); the weights
        are replicated from its first rank."""
        _check_quantize(quantize)
        if vocoder_type not in ("hifigan", "vocos"):
            raise ValueError(f"unknown vocoder_type {vocoder_type!r}; "
                             "'hifigan' or 'vocos'")
        self.compute_dtype = compute_dtype
        self.vocoder_type = vocoder_type
        self.model = FastPitchTTS(model_sd_path, config=config,
                                  arabic_in=arabic_in, vowelizer=vowelizer,
                                  seed=seed, strict_text=strict_text,
                                  device=device, mesh=mesh)
        self.device = self.model.device
        if vocoder_type == "vocos":
            self._init_vocos(vocoder_sd, seed)
        else:
            self._init_hifigan(vocoder_sd, vocoder_config, seed,
                               model_sd_path is not None)
        if mesh is not None:
            replicate([self.vocoder, self.bias_spec], mesh)
        # the generator tts() and stream() run: the float module, or its
        # int8 form after calibrate_int8
        self._vocode = self.vocoder
        self._int8_scales = None
        self._ffn_scales = None
        if quantize == "int8":
            self.calibrate_int8()

    def _init_hifigan(self, vocoder_sd, vocoder_config, seed, enabled):
        vocoder_sd, vocoder_config = _default_vocoder_paths(
            vocoder_sd, vocoder_config, enabled=enabled)
        self.vocoder_config = (HiFiGANConfig.from_json(vocoder_config)
                               if vocoder_config is not None
                               else HiFiGANConfig())
        self._sample_rate = self.vocoder_config.sampling_rate
        self._hop = self.vocoder_config.hop_length
        self.vocoder = Generator(self.vocoder_config)
        if vocoder_sd is not None:
            sd, _ = load_reference_pth(vocoder_sd)
            self.vocoder.load_state_dict(to_tensors(fold_weight_norm(sd)),
                                         strict=True)
        else:
            init_weights(self.vocoder, seed + 1)
        self.vocoder.to(self.device).eval()
        with _exact_f32():
            self.bias_spec = denoiser_mod.compute_bias_spec(
                self.vocoder, self.vocoder_config.num_mels,
                device=self.device)

    def _init_vocos(self, vocoder_sd, seed):
        from ..vocoder.vocos import (CONFIG_22K, MelVocosModule, init_vocos,
                                     load_vocos_state)
        cfg = CONFIG_22K
        self.vocoder_config = None
        self._sample_rate, self._hop = cfg["sample_rate"], cfg["hop_length"]
        self.vocoder = MelVocosModule(**{k: v for k, v in cfg.items()
                                         if k != "sample_rate"})
        if vocoder_sd is not None:
            load_vocos_state(self.vocoder, load_reference_pth(vocoder_sd)[0])
        else:
            init_vocos(self.vocoder, seed + 1)
        self.vocoder.to(self.device).eval()
        with _exact_f32():
            self.bias_spec = self.vocoder.bias_vector()

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def hop_length(self) -> int:
        return self._hop

    def calibrate_int8(self, texts: Optional[List[str]] = None, mels=None,
                       min_ch: int = 64, margin: float = 1.0, ffn="auto"):
        """Switch the serving path to static-calibrated int8 (JAX
        `calibrate_int8`): the HiFi-GAN MRF stages of >= min_ch channels
        and, when calibrating from texts, the decoder's ConvFFN convs
        (encode, durations and pitch stay float, so output lengths do not
        change).

        The per-conv activation scales come from `mels` ([B, T, 80], one
        or a list), or from mels this model decodes (in the compute dtype)
        for `texts` (default: a built-in phoneme-diverse set). tts() and
        stream() take the int8 path at once; CUDA graphs that warmup()
        captured are dropped and captured again in the new mode. Returns
        the vocoder's scales. HiFi-GAN ResBlock1 checkpoints only. ffn:
        True, False or "auto" (the decoder FFN too when calibrating from
        texts)."""
        if self.vocoder_type != "hifigan":
            raise ValueError("int8 quantization covers the HiFi-GAN path")
        if self.vocoder_config.resblock != "1":
            raise ValueError("int8 quantization covers ResBlock1 configs")
        from ..ops.hifigan_int8 import (check_stages, collect_mrf_scales,
                                        generator_apply_int8)
        check_stages(self.vocoder_config, min_ch)
        m = self.model
        dt = self.compute_dtype
        if ffn == "auto":
            ffn = mels is None
        if ffn and mels is not None:
            raise ValueError("decoder-FFN calibration needs the texts path "
                             "(pass texts=..., or ffn=False with mels=...)")
        ffn_scales = None
        with _exact_f32():
            if mels is None:
                ids = m.tokenize_batch(
                    _calibration_texts(texts, m.arabic_in), None)
                if ffn:
                    mel, ffn_scales = self._calibration_decode(ids, margin)
                else:
                    mel = m._infer_batch_mel(ids, 1.0, 0, 1.0, 0.0)[0]
                mels = [mel]
            elif isinstance(mels, (torch.Tensor, np.ndarray)):
                mels = [mels]
            mels = [torch.as_tensor(x).to(self.device, dt or torch.float32)
                    for x in mels]
            scales = collect_mrf_scales(self.vocoder, mels, min_ch=min_ch,
                                        margin=margin)
        self._vocode = functools.partial(generator_apply_int8, self.vocoder,
                                         scales=scales, min_ch=min_ch)
        self._int8_scales = scales
        self._ffn_scales = ffn_scales
        if m._graphs:   # captured in the old mode: capture them again
            m._graphs.clear()
            m.capture_graphs(dt, ffn_scales)
        return scales

    def _calibration_decode(self, ids, margin: float):
        """One float decode of the calibration texts in the compute dtype,
        recording each decoder ConvFFN's input max-abs (JAX's "calib"
        collection): (the mels, padded with LOG_MEL_PAD; the FFN scales,
        one f32 [2] device tensor a layer)."""
        m = self.model
        enc = m._encode_batch(ids, 0, 1.0, 0.0, None, 1.0)[0]
        bucket = _pick_mel_bucket(int(enc["dec_len_max"]))
        enc_out = enc["enc_out"]
        if self.compute_dtype is not None:
            enc_out = enc_out.to(self.compute_dtype)
        regulated, mel_lens = regulate_len(enc["dur_pred"], enc_out, bucket,
                                           1.0)
        with m.model.decoder.calibrate_ffn() as stats:
            mel = m._decoder_fn(regulated, mel_lens)
        ffn_scales = [torch.tensor(
            [max(float(s["ffn_amax1"]), 1e-12) * margin / 127.0,
             max(float(s["ffn_amax2"]), 1e-12) * margin / 127.0],
            dtype=torch.float32, device=self.device) for s in stats]
        return mel, ffn_scales

    def _vocode_mel(self, mel, denoise_strength: float, use_denoiser: bool):
        """The vocoder (+ denoiser) on a mel window or a whole call's mel
        (after chunked_vocode's split): f32 wave."""
        if self.vocoder_type == "vocos":
            strength = denoise_strength if use_denoiser else 0.0
            return self.vocoder(mel, self.bias_spec.to(mel.dtype),
                                strength).float()
        wave = self._vocode(mel).float()
        if use_denoiser:
            wave = denoiser_mod.denoise(wave, self.bias_spec,
                                        denoise_strength)
        return wave

    def _wave_fn(self, enc_out, durations, denoise_strength, pace, *,
                 max_frames, use_denoiser, return_mel=False,
                 out_int16=False):
        m = self.model
        with span("tts.decode", device=self.device):
            if enabled():
                count(frames_decoded=enc_out.shape[0] * max_frames)
            if self.compute_dtype is not None:
                enc_out = enc_out.to(self.compute_dtype)
            mel, mel_lens = m._decode_fn(enc_out, durations, pace,
                                         max_frames=max_frames,
                                         ffn_scales=self._ffn_scales)
        if self.vocoder_type == "vocos":
            # the ConvNeXt stack sees about +-27 frames: a 32-frame overlap
            # keeps chunked == whole (JAX infer/pipeline.py:616-624)
            with span("tts.vocode", device=self.device):
                wave = chunked_vocode(
                    lambda x: self._vocode_mel(x, denoise_strength,
                                               use_denoiser),
                    mel, core=192, overlap=32)
        else:
            with span("tts.vocode", device=self.device):
                wave = chunked_vocode(self._vocode, mel).float()
            if use_denoiser:
                with span("tts.denoise", device=self.device):
                    wave = denoiser_mod.denoise(wave, self.bias_spec,
                                                denoise_strength)
        mel = mel.float() if return_mel else None
        return _output(wave, out_int16), mel, mel_lens

    def _dispatch_encode(self, batch, speed, speaker_id, vowelizer,
                         pitch_mul, pitch_add, pad_to):
        m = self.model
        with span("tts.frontend"):
            if enabled():
                count(utterances=len(batch))
            ids = m.tokenize_batch(batch, vowelizer)
        with span("tts.encode", device=self.device):
            return m._encode_batch(ids, speaker_id, pitch_mul, pitch_add,
                                   pad_to, speed, shard=True)

    def _dispatch_wave(self, enc_handles, speed, denoise, return_mel,
                       out_int16=False, dec_len_max=None):
        """Mel bucket from the batch's longest predicted length, then decode
        + vocode (+ denoise) at that bucket; the wave is cropped on the
        device to the real lengths rounded up to _CROP_FRAMES, so the copy
        to the host skips most bucket padding. On a mesh `dec_len_max` is
        the batch's over every rank, and this rank's rows are gathered."""
        m = self.model
        enc, inverse, _ = enc_handles
        if dec_len_max is None:
            dec_len_max = m._global_max(enc["dec_len_max"])
        bucket = _pick_mel_bucket(dec_len_max)
        with _exact_f32():
            wave, mel, mel_lens = self._wave_fn(
                enc["enc_out"], enc["dur_pred"], float(denoise),
                float(speed), max_frames=bucket, use_denoiser=denoise > 0,
                return_mel=return_mel, out_int16=out_int16)
        frames = min(_round_up(dec_len_max, self._CROP_FRAMES), bucket)
        wave = wave[:, : frames * self.hop_length]
        if mel is not None:
            mel = mel[:, :frames]
        if m.mesh is not None:
            wave, mel, mel_lens = map(m._gather, (wave, mel, mel_lens))
        return wave, mel, mel_lens, inverse

    # crop granularity (frames) for device-side trims before the copy to
    # the host
    _CROP_FRAMES = 64

    def _collect_batch(self, handles, return_mel):
        """Copy to the host, crop per utterance, unsort."""
        wave, mel, mel_lens, inverse = handles
        with span("tts.collect"):
            wave = wave.cpu().numpy()
            lens = mel_lens.cpu().numpy()
            if enabled():
                count(frames_kept=int(lens[inverse].sum()))
            hop = self.hop_length
            waves = [wave[i, : lens[i] * hop] for i in inverse]
            if return_mel:
                mel = mel.cpu().numpy()
                return waves, [mel[i, : lens[i]].T for i in inverse]
        return waves

    def tts_batch(self, batch: List[str], speed: float = 1.0,
                  speaker_id: int = 0, denoise: float = 0.0,
                  vowelizer: Optional[str] = None, pitch_mul: float = 1.0,
                  pitch_add: float = 0.0, return_mel: bool = False,
                  pad_to=None, out_int16: bool = False):
        enc = self._dispatch_encode(batch, speed, speaker_id, vowelizer,
                                    pitch_mul, pitch_add, pad_to)
        handles = self._dispatch_wave(enc, speed, denoise, return_mel,
                                      out_int16)
        return self._collect_batch(handles, return_mel)

    def tts_single(self, utterance: str, **kw):
        out = self.tts_batch([utterance], **kw)
        if kw.get("return_mel"):
            return out[0][0], out[1][0]
        return out[0]

    # -- streaming synthesis ---------------------------------------------

    def _stream_chunk_fn(self, mel, start: int, denoise_strength: float, *,
                         window: int, use_denoiser: bool, out_int16):
        """Vocode (+ denoise in f32) `window` frames of the decoded mel
        from frame `start`, with the generator tts() uses."""
        piece = mel[:, start: start + window].contiguous()
        return _output(self._vocode_mel(piece, denoise_strength,
                                        use_denoiser), out_int16)

    def stream(self, utterance: str, chunk_frames: int = 128,
               overlap: int = 16, speed: float = 1.0, denoise: float = 0.005,
               speaker_id: int = 0, vowelizer: Optional[str] = None,
               pitch_mul: float = 1.0, pitch_add: float = 0.0,
               out_int16: bool = False):
        """Streaming synthesis: yields numpy waveform chunks of
        `chunk_frames * hop` samples (the last one shorter) as each is
        vocoded, so the first audio waits for one window, not the whole
        utterance (JAX `stream`).

        The chunks concatenate to `tts_single`'s wave to float tolerance:
        the whole mel is decoded once in the compute dtype, and each window
        of `chunk_frames + 2 * overlap` frames carries `overlap` >= the
        HiFi-GAN receptive field (~13 frames) + the denoiser's STFT context
        (4 frames); its core is cut at the window's own offset. Window
        starts are whole frames, so the denoiser's STFT grid lines up with
        the full wave's.

        The first window is vocoded from a mel decoded at
        STREAM_SPEC_FRAMES' bucket before the utterance's length reaches
        the host, so its device work is queued while the host waits. The
        decoder masks attention at the true length, so that mel is the mel
        whenever the length plus a window fits the bucket; otherwise the
        mel is decoded again at the length's own bucket.

        The encode and decode are tts_single's, graphs included."""
        m = self.model
        window = chunk_frames + 2 * overlap
        chunk = dict(window=window, use_denoiser=denoise > 0,
                     out_int16=out_int16)
        bucket0 = _pick_mel_bucket(max(window, STREAM_SPEC_FRAMES))

        def decode(enc_out, durations, frames):
            return m._decode_fn(enc_out, durations, float(speed),
                                max_frames=frames,
                                ffn_scales=self._ffn_scales)[0]

        enc = m._encode_batch([m.tokenize(utterance, vowelizer)], speaker_id,
                              pitch_mul, pitch_add, speed=speed)[0]
        with _exact_f32():
            enc_out, durations = enc["enc_out"], enc["dur_pred"]
            if self.compute_dtype is not None:  # the decode dtype of tts()
                enc_out = enc_out.to(self.compute_dtype)
            mel = decode(enc_out, durations, bucket0)
            wave0 = self._stream_chunk_fn(mel, 0, float(denoise), **chunk)
        dec_len = int(enc["dec_len_max"])      # waits for the host copy
        speculation_ok = dec_len + window <= bucket0
        if speculation_ok:
            bucket = bucket0
        else:
            bucket = _pick_mel_bucket(max(dec_len, window))
            with _exact_f32():
                mel = decode(enc_out, durations, bucket)
        hop = self.hop_length
        for i in range(max(-(-dec_len // chunk_frames), 1)):
            core_len = min(chunk_frames, dec_len - i * chunk_frames)
            if i == 0 and speculation_ok:
                yield wave0[0, : core_len * hop].cpu().numpy()
                continue
            start = int(np.clip(i * chunk_frames - overlap, 0,
                                bucket - window))
            core_off = i * chunk_frames - start
            with _exact_f32():
                wave = self._stream_chunk_fn(mel, start, float(denoise),
                                             **chunk)
            yield wave[0, core_off * hop: (core_off + core_len) * hop].cpu(
            ).numpy()

    def warmup(self, batch_sizes=(2,), text_buckets=(16, 32),
               mel_buckets=(256, 512, 1024), denoise: float = 0.005,
               return_mel: bool = False, out_int16: bool = False):
        """Run each (batch size, text bucket, mel bucket) once on zero
        tokens, so the first request pays no kernel build or cuDNN
        algorithm search; then capture the one-row encode and decoder
        graphs (FastPitchTTS.capture_graphs) in the decode dtype. On a mesh
        a batch size rounds up to the data axis and each rank runs its
        share of the rows, as a real request."""
        m = self.model
        for bs in batch_sizes:
            if m.mesh is not None:
                bs = -(-bs // m.mesh.axis_size(DATA_AXIS))
            for tb in text_buckets:
                tokens = torch.zeros((bs, tb), dtype=torch.long,
                                     device=self.device)
                with _exact_f32():
                    enc = m._encode_fn(tokens, 1.0, 0.0, 0, 1.0)
                    for mb in mel_buckets:
                        self._wave_fn(enc["enc_out"], enc["dur_pred"],
                                      float(denoise), 1.0, max_frames=mb,
                                      use_denoiser=denoise > 0,
                                      return_mel=return_mel,
                                      out_int16=out_int16)
        m.capture_graphs(self.compute_dtype, self._ffn_scales)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tts(self, text_input: Union[str, List[str]], speed: float = 1.0,
            denoise: float = 0.005, speaker_id: int = 0, batch_size: int = 2,
            vowelizer: Optional[str] = None, pitch_mul: float = 1.0,
            pitch_add: float = 0.0, return_mel: bool = False,
            out_int16: bool = False):
        """Synthesize speech (API of reference `FastPitch2Wave.tts`,
        networks.py:352-435).

        Returns waveform(s) as numpy float32 [n_samples] at 22050 Hz.
        `out_int16`: False (float32) | True (int16) | "mulaw" (uint8
        G.711-style codes, companded on the device; decode with
        `audio.mulaw_decode`)."""
        kw = dict(speed=speed, denoise=denoise, speaker_id=speaker_id,
                  vowelizer=vowelizer, pitch_mul=pitch_mul,
                  pitch_add=pitch_add, return_mel=return_mel,
                  out_int16=out_int16)
        with span("tts"):
            if isinstance(text_input, str):
                return self.tts_single(text_input, **kw)
            return self._tts_batches(text_input, batch_size, **kw)

    def _tts_batches(self, text_input: List[str], batch_size: int, *,
                     speed, denoise, speaker_id, vowelizer, pitch_mul,
                     pitch_add, return_mel, out_int16):
        # global length sort before batching, so batches are homogeneous in
        # length and bucket padding stays small
        order = sorted(range(len(text_input)),
                       key=lambda i: -len(text_input[i]))
        bs = max(batch_size, 1)
        batches = [order[k: k + bs] for k in range(0, len(order), bs)]
        # every encode is queued before the one host fetch of the bucket
        # scalars; every wave is queued before the first copy back
        encs = [self._dispatch_encode([text_input[i] for i in idxs], speed,
                                      speaker_id, vowelizer, pitch_mul,
                                      pitch_add, pad_to=bs)
                for idxs in batches]
        maxes = self.model._global_max(
            torch.stack([e[0]["dec_len_max"] for e in encs]))
        handles = [self._dispatch_wave(e, speed, denoise, return_mel,
                                       out_int16, dec_len_max=int(mx))
                   for e, mx in zip(encs, maxes)]
        waves = [None] * len(text_input)
        mels = [None] * len(text_input)
        for idxs, h in zip(batches, handles):
            out = self._collect_batch(h, return_mel)
            batch_waves, batch_mels = out if return_mel else (out, None)
            for j, i in enumerate(idxs):
                waves[i] = batch_waves[j]
                if return_mel:
                    mels[i] = batch_mels[j]
        return (waves, mels) if return_mel else waves
