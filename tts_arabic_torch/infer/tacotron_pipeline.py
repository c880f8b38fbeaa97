"""Tacotron2 inference pipelines (torch counterpart of the JAX package's
`infer/tacotron_pipeline.py`): `Tacotron2TTS.ttmel()`,
`Tacotron2Wave.tts()` and `Tacotron2Wave.stream()`.

The reference wrappers' behaviour: EOS-aware mel postprocessing (an extra
separator token after an "unsafe" final token, then the mel truncated
where that token's attention first peaks: `needs_postprocessing` /
`truncate_mel`), speed by a cubic mel resize (`resize_mel`), vowelizer
hooks, batched synthesis (batch size 8), HiFi-GAN and the denoiser.

Execution on the card:

1. tokenize on the host; sort by length; pad ids to a multiple of 16 and
   rows to the batch size
2. encode in `compute_dtype` (f32 by default, TF32 off: the stop step is
   a threshold on a sigmoid), then the autoregressive decode as blocks of
   predicated steps (`models.tacotron2.decode_block`): the host reads the
   run flag once per block. A (batch, text length) that `warmup()`
   captured replays one CUDA graph per block; any other shape runs the
   same block eagerly, still on the card
3. `tts()` without `speed` or `return_mel` truncates at the EOS marker on
   the device (`_newlen_fn`, `_assemble_fn`) and vocodes there, so only
   the waves are copied to the host; otherwise the mels are postprocessed
   on the host and vocoded at a mel bucket
4. HiFi-GAN (its ResBlocks on the CUDA kernels) and the denoiser in f32

Entry points run on the card: `device=None` means "cuda" and raises when
there is no CUDA device; pass `device="cpu"` to run on the CPU.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Union

import numpy as np
import torch

from .. import text as text_frontend
from ..models.convert import fold_weight_norm, load_reference_pth, to_tensors
from ..models.layers import init_weights
from ..models.tacotron2 import Tacotron2, Tacotron2Config, init_tacotron2
from ..runtime.checkpoint import load_states
from ..runtime.device import resolve_device
from ..vocoder import denoiser as denoiser_mod
from ..vocoder.hifigan import Generator, HiFiGANConfig, chunked_vocode
from .pipeline import (LOG_MEL_PAD, TEXT_BUCKET, _calibration_texts,
                       _check_quantize, _default_vocoder_paths, _exact_f32,
                       _output, _pad_ids, _pick_mel_bucket, _round_up)

# tokens whose trailing sound the stop token tends to cut; after any other
# final token the reference inserts an extra separator and truncates on
# its attention (networks.py:39-41)
_SAFE_FINAL_TOKENS = frozenset(
    ["a", "i", "u", "aa", "ii", "uu", "n", "m", "h"])
N_EOS = len(text_frontend.EOS_TOKENS)  # separator + eos


def _speaker_array(speaker_id, n: int) -> np.ndarray:
    """Scalar or per-utterance speaker ids -> int64 [n]."""
    spk = np.asarray(speaker_id, np.int64)
    if spk.ndim == 0:
        return np.full((n,), int(spk), np.int64)
    if spk.shape != (n,):
        raise ValueError(
            f"speaker_id must be a scalar or a length-{n} sequence, "
            f"got shape {spk.shape}")
    return spk


def _subset_speakers(speaker_id, idxs):
    """A per-utterance speaker sequence cut to a batch's indices (scalars
    pass through)."""
    if np.ndim(speaker_id) == 0:
        return speaker_id
    return np.asarray(speaker_id, np.int64)[np.asarray(idxs, int)]


def needs_postprocessing(token: str) -> bool:
    return token not in _SAFE_FINAL_TOKENS


def truncate_mel(mel: np.ndarray, attn_col: np.ndarray) -> np.ndarray:
    """Crop [n_mels, T] where the end-marker token's attention first reaches
    80% of its max; pad 3 replicated frames (networks.py:44-49)."""
    peak = attn_col.max()
    idx = np.flatnonzero(attn_col >= 0.8 * peak)
    n_end = int(idx[0]) if idx.size else mel.shape[1]
    cut = mel[:, :max(n_end, 1)]
    return np.concatenate([cut, np.repeat(cut[:, -1:], 3, axis=1)], axis=1)


def _cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of `jax.image.resize(method="cubic")`
    along one axis: Keys cubic (a = -0.5) at half-pixel centres, the
    kernel widened by the shrink factor when shrinking (antialiasing),
    each output's weights renormalised over the taps in range, and an
    output whose centre falls outside the input set to zero."""
    f32 = np.float32
    inv_scale = f32(n_in / n_out)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x
                 + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_mel(mel: np.ndarray, rate: float = 1.0) -> np.ndarray:
    """Speed control by a cubic time-axis resize of [n_mels, T] to
    int(T / rate) frames (networks.py:52-67; the JAX package's
    `jax.image.resize(method="cubic")`, not torch's bicubic), one matmul
    with the resize matrix."""
    n_mels, T = mel.shape
    T_new = int(T / rate)
    if T_new == T:
        return mel
    if T_new == 0:
        return np.zeros((n_mels, 0), np.float32)
    w = _cubic_resize_matrix(T, T_new)
    return np.matmul(mel.astype(np.float32), w).astype(np.float32)


class Tacotron2TTS:
    """Text -> mel via autoregressive Tacotron2 (reference `Tacotron2`
    wrapper equivalent).

    checkpoint: a reference `.pth` (its 'config' and 'symbols' extras are
    read), a training checkpoint (`states.ckpt` with a 'model' state dict
    and the config's `net_config`), or None for seeded random weights."""

    def __init__(self, checkpoint=None, config: Tacotron2Config | None = None,
                 arabic_in: bool = True, vowelizer: Optional[str] = None,
                 decoder_max_step: int = 3000, seed: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 strict_text: bool = False, device=None):
        """compute_dtype: torch.bfloat16 encodes, decodes and runs the
        postnet in bf16 (the weights are cast per call, as the JAX
        package's `cast_floating`); None = f32 throughout.

        strict_text: False (default) drops tokens outside the symbol table
        (trailing punctuation); True raises the reference's KeyError."""
        self.device = resolve_device(device)
        self.arabic_in = arabic_in
        self.strict_text = strict_text
        self.compute_dtype = compute_dtype
        self.default_vowelizer = vowelizer
        self._vowelizers = {}
        self.phon_to_id = None
        self.decoder_max_step = decoder_max_step
        self._graphs = {}        # see capture_graphs
        self.graph_replays = 0
        sd = None
        if checkpoint is not None:
            sd, config = self._load_checkpoint(checkpoint, config)
        self.config = config or Tacotron2Config()
        self.model = Tacotron2(self.config)
        if sd is None:
            init_tacotron2(self.model, seed)
        else:
            self.model.load_state_dict(to_tensors(sd), strict=True)
        self.model.to(self.device).eval()

    def _load_checkpoint(self, checkpoint, config):
        path = str(checkpoint)
        if path.endswith((".pth", ".pt")):
            sd, extras = load_reference_pth(path)
            if config is None:
                ref_cfg = extras.get("config") or {}
                config = Tacotron2Config(**{
                    k: v for k, v in ref_cfg.items()
                    if k in Tacotron2Config.__dataclass_fields__})
            if "symbols" in extras:
                self.phon_to_id = {p: i for i, p in
                                   enumerate(extras["symbols"])}
            return sd, config
        state = load_states(path)
        if config is None:
            cfg = (state.get("config") or {}).get("net_config")
            config = Tacotron2Config(**cfg) if cfg else Tacotron2Config()
        return state["model"], config

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    # -- text frontend (append_space=True, unlike FastPitch) -----------------

    def _vowelizer(self, vowelizer: Optional[str]):
        name = vowelizer or self.default_vowelizer
        if name is None:
            return None
        if name not in self._vowelizers:
            from ..diacritizers import load_vowelizer
            self._vowelizers[name] = load_vowelizer(name, device=self.device)
        return self._vowelizers[name]

    def _tokens(self, utterance: str) -> List[str]:
        to_tokens = (text_frontend.arabic_to_tokens if self.arabic_in
                     else text_frontend.buckwalter_to_tokens)
        toks = to_tokens(utterance)
        if not self.strict_text:
            # sanitize ONCE, at the token level, so the EOS-postprocess
            # index, the attention-column gather and the strict id mapping
            # at dispatch all see one sequence
            return text_frontend.sanitize_tokens(toks, self.phon_to_id)
        # the reference's KeyError on punctuation, raised here
        text_frontend.tokens_to_ids(toks, self.phon_to_id)
        return toks

    def tokenize(self, utterance: str,
                 vowelizer: Optional[str] = None) -> List[str]:
        model = self._vowelizer(vowelizer)
        if model is not None:
            utterance = model.predict(
                text_frontend.buckwalter_to_arabic(utterance))
        return self._tokens(utterance)

    def tokenize_batch(self, batch: List[str],
                       vowelizer: Optional[str] = None) -> List[List[str]]:
        """tokenize() of each utterance, with one batched diacritizer
        forward for the whole batch."""
        model = self._vowelizer(vowelizer)
        if model is None:
            return [self._tokens(t) for t in batch]
        vowelized = model.predict(
            [text_frontend.buckwalter_to_arabic(t) for t in batch])
        return [self._tokens(v) for v in vowelized]

    # -- CUDA graphs of a decode block ---------------------------------------

    def capture_graphs(self, batch_sizes=(1,), text_buckets=(16, 32)) -> None:
        """Record one decode block (`Tacotron2.decode_block`) as a CUDA
        graph for each (batch size, padded text length), in the compute
        dtype, at `decoder_max_step` and with the model config's
        `decoder_early_stopping` (`_graph_key`). A decode or stream segment
        of that key then replays it, block after block; others run the
        block eagerly. Does nothing off the card. The graphs of one call
        share a memory pool for their intermediates; a block reads and
        writes only tensors allocated outside it, and a call copies its
        results out, so a pipeline serves one call at a time."""
        if self.device.type != "cuda":
            return
        m, dev, dt = self.model, self.device, self.dtype
        c, S = self.config, self.decoder_max_step
        pool = torch.cuda.graph_pool_handle()
        with _exact_f32():
            for B in batch_sizes:
                for T in text_buckets:
                    key = self._graph_key(B, T)
                    if key in self._graphs:
                        continue
                    memory = torch.zeros((B, T, c.memory_dim), dtype=dt,
                                         device=dev)
                    enc = {"memory": memory,
                           "processed_memory": torch.zeros(
                               (B, T, c.attention_hidden_dim), dtype=dt,
                               device=dev),
                           "memory_mask": torch.ones((B, T), dtype=torch.bool,
                                                     device=dev)}
                    carry = m.init_decode_carry(memory)
                    bufs = m.decode_buffers(memory, S)
                    masks = m.prenet_masks(S, B, dev)
                    limit = torch.full((1,), S, dtype=torch.long, device=dev)
                    m.start_segment(carry, limit)

                    def block(carry=carry, enc=enc, bufs=bufs, masks=masks,
                              limit=limit):
                        m.decode_block(carry, enc, bufs, masks, limit)
                    side = torch.cuda.Stream(dev)
                    side.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(side):   # cuBLAS/cuDNN handles
                        block()
                    torch.cuda.current_stream(dev).wait_stream(side)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool):
                        block()
                    self._graphs[key] = (graph, carry, enc, bufs, masks,
                                         limit)
        torch.cuda.synchronize(dev)

    def _graph_key(self, batch: int, text_len: int) -> tuple:
        """What a captured block depends on besides the weights: the shape,
        the step cap, the dtype, and whether the run flag drops once every
        row has stopped (a block recorded with early stopping stops where a
        decode without it must go on)."""
        return (batch, text_len, self.decoder_max_step, self.dtype,
                self.model.config.decoder_early_stopping)

    def _runner(self, batch: int, text_len: int):
        """The graph replay of the blocks of a segment at this shape, in the
        signature of `Tacotron2.run_segment`; None when no graph was
        captured for it."""
        entry = self._graphs.get(self._graph_key(batch, text_len))
        if entry is None:
            return None
        graph, s_carry, s_enc, s_bufs, s_masks, s_limit = entry

        def run(carry, enc, bufs, masks, limit):
            for key, val in s_enc.items():
                val.copy_(enc[key])
            if s_masks is not None:
                s_masks.copy_(masks)
            s_limit.copy_(limit)
            for key, val in s_carry.items():
                val.copy_(carry[key])
            for val in s_bufs.values():
                val.zero_()
            self.graph_replays += self.model.run_segment(
                s_carry, s_enc, s_bufs, s_masks, s_limit, block=graph.replay)
            for key, val in carry.items():
                val.copy_(s_carry[key])
            for key, val in bufs.items():
                val.copy_(s_bufs[key][:, : val.shape[1]])
        return run

    # -- the decode ----------------------------------------------------------

    def _infer(self, padded: np.ndarray, lens: np.ndarray, speakers,
               generator=None) -> dict:
        """Padded ids [B, T] -> the decode's outputs on the device, float
        ones in f32."""
        dev = self.device
        tokens = torch.from_numpy(np.asarray(padded, np.int64)).to(dev)
        spk = torch.from_numpy(np.asarray(speakers, np.int64)).to(dev)
        with _exact_f32():
            out = self.model.infer(
                tokens, torch.from_numpy(np.asarray(lens, np.int64)), spk,
                max_steps=self.decoder_max_step, generator=generator,
                dtype=self.dtype, runner=self._runner(*tokens.shape))
        return {k: v.float() if v.is_floating_point() else v
                for k, v in out.items()}

    def _sorted_batch(self, tokens_list, speaker_id, pad_to):
        """Strict id mapping of pre-sanitized token lists (so the
        EOS-postprocess separator survives and the end-marker index stays
        consistent), sorted by length, rows padded to `pad_to`. -> (padded
        ids, sorted lens, sorted speakers, order, ids_list)."""
        n_real = len(tokens_list)
        ids_list = [np.asarray(text_frontend.tokens_to_ids(
            t, self.phon_to_id), np.int64) for t in tokens_list]
        lens = np.asarray([len(x) for x in ids_list])
        order = np.argsort(-lens)
        ids_sorted = [ids_list[i] for i in order]
        lens_sorted = lens[order]
        spk_sorted = _speaker_array(speaker_id, n_real)[order]
        if pad_to is not None and n_real < pad_to:
            pad = pad_to - n_real
            ids_sorted += [np.zeros(1, np.int64)] * pad
            lens_sorted = np.concatenate([lens_sorted, np.ones(pad, int)])
            spk_sorted = np.concatenate([spk_sorted, np.zeros(pad, int)])
        padded = _pad_ids(ids_sorted, _round_up(int(lens.max()), TEXT_BUCKET))
        return padded, lens_sorted, spk_sorted, order, ids_list

    def _dispatch_infer(self, tokens_list: List[List[str]], speaker_id,
                        pad_to=None, generator=None):
        """Token lists -> (decode outputs on the device, token lens, inverse
        order)."""
        padded, lens_sorted, spk, order, ids_list = self._sorted_batch(
            tokens_list, speaker_id, pad_to)
        out = self._infer(padded, lens_sorted, spk, generator)
        lens = np.asarray([len(x) for x in ids_list])
        return out, lens, np.argsort(order)

    def _infer_batch(self, tokens_list, speaker_id, pad_to=None,
                     generator=None):
        """Token lists -> (mel_postnet [B, S, 80], mel lens, aligns, lens,
        inverse), on the host."""
        out, lens, inverse = self._dispatch_infer(tokens_list, speaker_id,
                                                  pad_to, generator)
        return (out["mel_postnet"].cpu().numpy(),
                out["mel_lens"].cpu().numpy(),
                out["alignments"].cpu().numpy(), lens, inverse)

    # -- public API ----------------------------------------------------------

    def _prepare_tokens(self, batch: List[str], vowelizer,
                        postprocess_mel: bool):
        """Tokenize + the EOS-postprocess separator (networks.py:134-137).
        Returns (tokens_list, do_post flags)."""
        tokens_list = self.tokenize_batch(batch, vowelizer)
        do_post = []
        for toks in tokens_list:
            p = postprocess_mel and needs_postprocessing(toks[-N_EOS - 1])
            if p:
                toks.insert(-N_EOS, text_frontend.SEPARATOR)
            do_post.append(p)
        return tokens_list, do_post

    def _finish_ttmel(self, mel_post, mel_lens, aligns, inverse, tokens_list,
                      do_post, speed):
        """Host postprocess of fetched decode outputs -> list of [80, T]."""
        mels = []
        for j, i in enumerate(inverse):
            L = mel_lens[i]
            mel = mel_post[i, :L].T  # [n_mels, T]
            if do_post[j]:
                attn_col = aligns[i, :L, len(tokens_list[j]) - N_EOS - 1]
                mel = truncate_mel(mel, attn_col)
            if speed is not None:
                mel = resize_mel(mel, rate=speed)
            mels.append(mel)
        return mels

    def ttmel_batch(self, batch: List[str], speaker_id=0,
                    speed: Optional[float] = None,
                    vowelizer: Optional[str] = None,
                    postprocess_mel: bool = True, pad_to=None,
                    generator=None):
        tokens_list, do_post = self._prepare_tokens(batch, vowelizer,
                                                    postprocess_mel)
        mel_post, mel_lens, aligns, _, inverse = self._infer_batch(
            tokens_list, speaker_id, pad_to, generator)
        return self._finish_ttmel(mel_post, mel_lens, aligns, inverse,
                                  tokens_list, do_post, speed)

    def ttmel_single(self, utterance: str, **kw):
        return self.ttmel_batch([utterance], **kw)[0]

    def ttmel(self, text_input: Union[str, List[str]], speaker_id=0,
              speed: Optional[float] = None, batch_size: int = 1,
              vowelizer: Optional[str] = None, postprocess_mel: bool = True):
        kw = dict(speed=speed, vowelizer=vowelizer,
                  postprocess_mel=postprocess_mel)
        if isinstance(text_input, str):
            if np.ndim(speaker_id) != 0:  # a length-1 sequence
                speaker_id = int(_speaker_array(speaker_id, 1)[0])
            return self.ttmel_single(text_input, speaker_id=speaker_id, **kw)
        if np.ndim(speaker_id) != 0:
            speaker_id = _speaker_array(speaker_id, len(text_input))
        out = []
        bs = max(batch_size, 1)
        for k in range(0, len(text_input), bs):
            idxs = range(k, min(k + bs, len(text_input)))
            out += self.ttmel_batch(
                text_input[k: k + bs], pad_to=bs,
                speaker_id=_subset_speakers(speaker_id, idxs), **kw)
        return out


class Tacotron2Wave:
    """End-to-end autoregressive text -> waveform (reference
    `Tacotron2Wave` equivalent): Tacotron2, HiFi-GAN (its ResBlocks on the
    CUDA kernels on the card) and the spectral denoiser."""

    def __init__(self, model_sd_path=None, vocoder_sd=None,
                 vocoder_config=None, vowelizer: Optional[str] = None,
                 arabic_in: bool = True, config=None, seed: int = 0,
                 compute_dtype: torch.dtype | None = None,
                 strict_text: bool = False, quantize: Optional[str] = None,
                 device=None):
        """compute_dtype: torch.bfloat16 runs the decode and the vocoder in
        bf16 (the denoiser stays f32); None = f32 throughout.

        vocoder_sd: a reference HiFi-GAN `.pth`; None takes the basic
        config's vocoder when an acoustic checkpoint is given and that file
        exists, else seeded random weights (seed + 1).

        quantize: None or "int8": the static-calibrated int8 MRF stages,
        as `FastPitch2Wave(quantize="int8")`; the constructor calibrates
        them on the built-in texts, decoded through this model."""
        _check_quantize(quantize)
        self.model = Tacotron2TTS(model_sd_path, config=config,
                                  arabic_in=arabic_in, vowelizer=vowelizer,
                                  seed=seed, compute_dtype=compute_dtype,
                                  strict_text=strict_text, device=device)
        self.device = self.model.device
        vocoder_sd, vocoder_config = _default_vocoder_paths(
            vocoder_sd, vocoder_config, enabled=model_sd_path is not None)
        self.vocoder_config = (HiFiGANConfig.from_json(vocoder_config)
                               if vocoder_config is not None
                               else HiFiGANConfig())
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
        # the generator tts() and stream() run: the float module, or its
        # int8 form after calibrate_int8
        self._vocode = self.vocoder
        self._int8_scales = None
        if quantize == "int8":
            self.calibrate_int8()

    def calibrate_int8(self, texts: Optional[List[str]] = None, mels=None,
                       min_ch: int = 64, margin: float = 1.0):
        """Switch the vocoder to the static-calibrated int8 MRF path (JAX
        `Tacotron2Wave.calibrate_int8`; HiFi-GAN ResBlock1 only): scales
        from `mels` ([B, T, 80], one or a list), or from `texts` decoded
        through this model (default: the built-in calibration set), their
        mels stacked at a mel bucket with LOG_MEL_PAD. tts() and stream()
        take it at once. Returns the scales."""
        if self.vocoder_config.resblock != "1":
            raise ValueError("int8 quantization covers HiFi-GAN ResBlock1 "
                             "configs")
        from ..ops.hifigan_int8 import (check_stages, collect_mrf_scales,
                                        generator_apply_int8)
        check_stages(self.vocoder_config, min_ch)
        if mels is None:
            got = self.model.ttmel_batch(
                _calibration_texts(texts, self.model.arabic_in))
            bucket = _pick_mel_bucket(max(m.shape[1] for m in got))
            stacked = np.full((len(got), bucket, got[0].shape[0]),
                              LOG_MEL_PAD, np.float32)
            for i, m in enumerate(got):
                stacked[i, : m.shape[1]] = m.T
            mels = [stacked]
        elif isinstance(mels, (torch.Tensor, np.ndarray)):
            mels = [mels]
        dt = self.compute_dtype or torch.float32
        with _exact_f32():
            scales = collect_mrf_scales(
                self.vocoder,
                [torch.as_tensor(m).to(self.device, dt) for m in mels],
                min_ch=min_ch, margin=margin)
        self._vocode = functools.partial(generator_apply_int8, self.vocoder,
                                         scales=scales, min_ch=min_ch)
        self._int8_scales = scales
        return scales

    @property
    def compute_dtype(self):
        return self.model.compute_dtype

    @property
    def sample_rate(self) -> int:
        return self.vocoder_config.sampling_rate

    @property
    def hop_length(self) -> int:
        return self.vocoder_config.hop_length

    # -- fused device path: decode -> truncate -> vocode on the device -------

    @staticmethod
    def _newlen_fn(alignments, mel_lens, trunc_idx, do_post):
        """The EOS truncation on the device (reference truncate_mel): the
        first frame where the end-marker token's attention reaches 80% of
        its peak. Returns (n_end, new_len)."""
        B, S, _ = alignments.shape
        col = alignments.gather(
            2, trunc_idx[:, None, None].expand(B, S, 1))[..., 0]
        frames = torch.arange(S, device=col.device)
        colv = torch.where(frames[None, :] < mel_lens[:, None], col,
                           -torch.inf)
        hit = colv >= 0.8 * colv.max(dim=1, keepdim=True).values
        first = hit.to(torch.uint8).argmax(dim=1).to(mel_lens.dtype)
        n_end = torch.clamp(torch.where(hit.any(dim=1), first, mel_lens),
                            min=1)
        return n_end, torch.where(do_post, n_end + 3, mel_lens)

    @staticmethod
    def _assemble_fn(mel, n_end, new_len, do_post, *, bucket: int):
        """The bucket-length vocoder input on the device: exactly the
        buffer the host path stacks (truncated, 3 replicated frames,
        LOG_MEL_PAD past each length)."""
        B, S, n_mels = mel.shape
        t = torch.arange(bucket, device=mel.device)
        rep = do_post[:, None] & (t[None, :] >= n_end[:, None])
        idx = torch.where(rep, (n_end - 1)[:, None].long(),
                          torch.clamp(t, max=S - 1)[None, :])
        out = mel.gather(1, idx[:, :, None].expand(B, bucket, n_mels))
        return torch.where(t[None, :, None] < new_len[:, None, None], out,
                           LOG_MEL_PAD)

    def _dispatch_fused(self, tokens_list, do_post, speaker_id, denoise,
                        pad_to=None, out_int16=False, generator=None):
        """Token lists -> the decode on the device and its truncation
        decision: (decode outputs, n_end, new_len, post, denoise,
        out_int16, inverse)."""
        m = self.model
        padded, lens_sorted, spk, order, ids_list = m._sorted_batch(
            tokens_list, speaker_id, pad_to)
        trunc = np.asarray([len(x) - N_EOS - 1 for x in ids_list])[order]
        post = np.asarray(do_post, bool)[order]
        pad = len(lens_sorted) - len(order)
        trunc = np.concatenate([trunc, np.zeros(pad, int)])
        post = np.concatenate([post, np.zeros(pad, bool)])
        out = m._infer(padded, lens_sorted, spk, generator)
        dev = self.device
        post_t = torch.from_numpy(post).to(dev)
        n_end, new_len = self._newlen_fn(
            out["alignments"], out["mel_lens"],
            torch.from_numpy(np.maximum(trunc, 0)).to(dev), post_t)
        return (out, n_end, new_len, post_t, denoise, out_int16,
                np.argsort(order))

    # crop granularity (frames) for the device-side trim before the copy to
    # the host
    _CROP_FRAMES = 64

    def _collect_fused(self, handles):
        """One small new_len copy picks the mel bucket (the host path's
        _pick_mel_bucket), then assemble + vocode on the device; only the
        cropped wave is copied to the host."""
        out, n_end, new_len, post, denoise, out_int16, inverse = handles
        new_lens = new_len.cpu().numpy()
        bucket = _pick_mel_bucket(max(int(new_lens.max()), 1))
        with _exact_f32():
            mel = self._assemble_fn(out["mel_postnet"], n_end, new_len, post,
                                    bucket=bucket)
            wave = self._vocode_fn(mel, float(denoise),
                                   use_denoiser=denoise > 0,
                                   out_int16=out_int16)
        hop = self.hop_length
        frames = _round_up(int(new_lens.max()), self._CROP_FRAMES)
        wave = wave[:, : frames * hop].cpu().numpy()
        return [wave[i, : new_lens[i] * hop] for i in inverse]

    def _vocode_fn(self, mel, strength: float, *, use_denoiser: bool,
                   out_int16=False):
        """HiFi-GAN in the compute dtype (chunked when long), then the
        denoiser in f32 and the output format."""
        if self.compute_dtype is not None:
            mel = mel.to(self.compute_dtype)
        wave = chunked_vocode(self._vocode, mel).float()
        if use_denoiser:
            wave = denoiser_mod.denoise(wave, self.bias_spec, strength)
        return _output(wave, out_int16)

    def _dispatch_vocode(self, mels, denoise, out_int16=False):
        """Stack host mels at a bucketed length and vocode on the device.
        Returns (wave on the device, per-mel frame lens)."""
        lens = [m.shape[1] for m in mels]
        bucket = _pick_mel_bucket(max(lens))
        stacked = np.full((len(mels), bucket, mels[0].shape[0]), LOG_MEL_PAD,
                          np.float32)
        for i, m in enumerate(mels):
            stacked[i, : m.shape[1]] = m.T
        with _exact_f32():
            wave = self._vocode_fn(torch.from_numpy(stacked).to(self.device),
                                   float(denoise), use_denoiser=denoise > 0,
                                   out_int16=out_int16)
        return wave, lens

    def _split_waves(self, wave, lens):
        wave = wave.cpu().numpy()
        hop = self.hop_length
        return [wave[i, : lens[i] * hop] for i in range(len(lens))]

    def tts_batch(self, batch: List[str], speaker_id=0,
                  speed: Optional[float] = None, denoise: float = 0.0,
                  vowelizer: Optional[str] = None, pitch_mul=None,
                  pitch_add=None, postprocess_mel: bool = True,
                  return_mel: bool = False, pad_to=None, out_int16=False,
                  generator=None):
        """The batch's waves (and mels with `return_mel`). `pitch_mul` and
        `pitch_add` are taken and ignored, as the JAX package's Tacotron2
        does: the model has no pitch input (the FastPitch wrapper's API)."""
        del pitch_mul, pitch_add
        mels = self.model.ttmel_batch(batch, speaker_id=speaker_id,
                                      speed=speed, vowelizer=vowelizer,
                                      postprocess_mel=postprocess_mel,
                                      pad_to=pad_to, generator=generator)
        wave, lens = self._dispatch_vocode(mels, denoise, out_int16)
        waves = self._split_waves(wave, lens)
        if return_mel:
            return waves, mels
        return waves

    def tts_single(self, utterance: str, **kw):
        out = self.tts_batch([utterance], **kw)
        if kw.get("return_mel"):
            return out[0][0], out[1][0]
        return out[0]

    # -- streaming synthesis (segmented autoregressive decode) ---------------

    # margin around each emitted core: postnet RF (10) + HiFi-GAN RF (~13)
    # + denoiser STFT context (4), rounded up
    _STREAM_MARGIN = 32

    def _stream_win_fn(self, mel_w, valid: int, strength: float, *,
                       use_denoiser: bool, out_int16):
        """Postnet + vocode one mel window [1, W, n_mels] (pre-postnet).
        The postnet re-masks its conv inputs at `valid` frames, as the
        batch path's postnet does at the length, and frames at index >=
        `valid` are reset to LOG_MEL_PAD after it, as the batch path's
        bucket padding."""
        if self.compute_dtype is not None:
            mel_w = mel_w.to(self.compute_dtype)
        lens = torch.full((1,), valid, dtype=torch.long, device=mel_w.device)
        post = mel_w + self.model.model.postnet(mel_w, lens)
        idx = torch.arange(mel_w.shape[1], device=mel_w.device)[None, :, None]
        post = torch.where(idx < valid, post, LOG_MEL_PAD)
        wave = self._vocode(post).float()
        if use_denoiser:
            wave = denoiser_mod.denoise(wave, self.bias_spec, strength)
        return _output(wave, out_int16)

    def stream(self, utterance: str, chunk_frames: int = 96,
               denoise: float = 0.005, speaker_id: int = 0,
               vowelizer: Optional[str] = None, out_int16=False,
               generator=None):
        """Streaming autoregressive synthesis (JAX `stream`): the decode
        runs in segments of `chunk_frames` steps and an audio chunk is
        yielded as soon as its lookahead margin is decoded, so the first
        audio waits for one segment, not the whole decode.

        Equals `tts_single(postprocess_mel=False)` to float tolerance, the
        prenet dropout included: the segments run `infer`'s predicated
        steps with the call's masks (the same generator seed), every
        emitted core carries a decoded margin >= the postnet, HiFi-GAN and
        denoiser receptive fields, and frames past the length are reset to
        LOG_MEL_PAD. Unlike the JAX package's windows, a window never
        reaches before frame 0 or past tts_single's mel bucket, and its
        postnet masks at the length: there JAX's first and last chunks
        read frames tts_single does not have. The segments replay the
        decode-block graph that `warmup()` captured at (1, padded text
        length), if any."""
        m = self.model
        toks = m.tokenize(utterance, vowelizer)
        ids = np.asarray(text_frontend.tokens_to_ids(toks, m.phon_to_id),
                         np.int64)
        dev, dt = self.device, m.dtype
        tokens = torch.from_numpy(
            _pad_ids([ids], _round_up(len(ids), TEXT_BUCKET))).to(dev)
        with _exact_f32():
            enc = m.model.encode_infer(
                tokens, torch.tensor([len(ids)]),
                torch.tensor([speaker_id], device=dev), dtype=dt)
            carry = m.model.init_decode_carry(enc["memory"])
            masks = m.model.prenet_masks(m.decoder_max_step, 1, dev,
                                         generator)
        runner = m._runner(*tokens.shape)

        margin = self._STREAM_MARGIN
        hop = self.hop_length
        mel_acc = np.zeros((1, 0, self.vocoder_config.num_mels), np.float32)
        emitted, length, done = 0, 0, False
        t_host, first_seg = 0, True
        win = dict(use_denoiser=denoise > 0, out_int16=out_int16)

        while True:
            if not done:
                # the FIRST segment decodes chunk + margin steps, so the
                # first core's lookahead lands in one segment; the tail
                # is capped so the decode stops exactly at
                # decoder_max_step, as in tts_single()
                want = chunk_frames + (margin if first_seg else 0)
                n_steps = min(want, m.decoder_max_step - t_host)
                if n_steps <= 0:
                    done = True
                else:
                    with _exact_f32():
                        carry, seg = m.model.decode_segment(
                            carry, enc, masks, n_steps=n_steps,
                            runner=runner)
                    first_seg = False
                    n_new = int(seg["n_new"])
                    t_host = int(carry["t"])
                    if n_new:
                        mel_acc = np.concatenate(
                            [mel_acc, seg["mel"][:, :n_new].float().cpu()
                             .numpy()], axis=1)
                    length = int(carry["lengths"][0])
                    done = (bool(carry["finished"].all())
                            or t_host >= m.decoder_max_step or n_new == 0)
            # emit every core whose lookahead margin is decoded (all the
            # remaining ones once the decode is done)
            while emitted < length and (
                    done or mel_acc.shape[1] - (emitted + chunk_frames)
                    >= margin):
                core_len = min(chunk_frames, length - emitted)
                # the window is clamped to the frames tts_single vocodes,
                # [0, its mel bucket), so at either end the postnet, the
                # generator and the denoiser pad as they do there
                lo = max(emitted - margin, 0)
                hi = emitted + chunk_frames + margin
                if done:
                    hi = min(hi, _pick_mel_bucket(length))
                window = np.zeros((1, hi - lo, mel_acc.shape[2]), np.float32)
                n = min(hi, mel_acc.shape[1]) - lo
                window[:, :n] = mel_acc[:, lo: lo + n]
                with _exact_f32():
                    wave_w = self._stream_win_fn(
                        torch.from_numpy(window).to(dev), length - lo,
                        float(denoise), **win)
                off = emitted - lo
                yield wave_w[0, off * hop: (off + core_len) * hop].cpu(
                ).numpy()
                emitted += core_len
            if done and emitted >= length:
                return

    def warmup(self, batch_sizes=(1,), text_buckets=(16, 32),
               denoise: float = 0.005, out_int16=False):
        """Capture the decode-block graph of each (batch size, text bucket)
        (`Tacotron2TTS.capture_graphs`), then run the fused decode ->
        truncate -> vocode path once at each on placeholder tokens, so the
        first request pays no kernel build or cuDNN algorithm search. Each
        runs a full-length decode: do it once, at server start. The vocoder
        meets the mel bucket the placeholder decode happens to produce;
        other buckets are planned on first use."""
        self.model.capture_graphs(batch_sizes, text_buckets)
        for bs in batch_sizes:
            for tb in text_buckets:
                toks = [["a"] * max(tb - N_EOS, 1)
                        + list(text_frontend.EOS_TOKENS)] * bs
                handles = self._dispatch_fused(
                    toks, [False] * bs, 0, denoise, pad_to=bs,
                    out_int16=out_int16)
                self._collect_fused(handles)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tts(self, text_input: Union[str, List[str]],
            speed: Optional[float] = None, denoise: float = 0.005,
            speaker_id=0, batch_size: int = 8,
            vowelizer: Optional[str] = None, postprocess_mel: bool = True,
            return_mel: bool = False, out_int16=False, generator=None):
        """Synthesize speech (API of reference `Tacotron2Wave.tts`,
        networks.py:347-426). Returns numpy waveform(s) at 22050 Hz.
        out_int16: False (f32) | True (int16) | "mulaw" (uint8 codes),
        converted on the device. speaker_id: a scalar, or one per
        utterance of a list. generator: draws the prenet dropout masks of
        every decode (default: a fresh one seeded 0 per decode)."""
        kw = dict(speed=speed, denoise=denoise, vowelizer=vowelizer,
                  postprocess_mel=postprocess_mel, return_mel=return_mel,
                  out_int16=out_int16, generator=generator)
        if isinstance(text_input, str):
            if np.ndim(speaker_id) != 0:  # a length-1 sequence
                speaker_id = int(_speaker_array(speaker_id, 1)[0])
            return self.tts_single(text_input, speaker_id=speaker_id, **kw)
        if np.ndim(speaker_id) != 0:
            speaker_id = _speaker_array(speaker_id, len(text_input))
        m = self.model
        # a global length sort, so each batch's decode (which runs until its
        # longest row stops) and its padding waste less; decodes run at
        # most WINDOW batches ahead of collection, so device memory stays
        # O(WINDOW) batches however long the list
        WINDOW = 4
        order = sorted(range(len(text_input)),
                       key=lambda i: -len(text_input[i]))
        bs = max(batch_size, 1)
        batches = [order[k: k + bs] for k in range(0, len(order), bs)]
        waves = [None] * len(text_input)
        mels = [None] * len(text_input)

        if speed is None and not return_mel:
            def collect_fused(item):
                idxs, handles = item
                for i, w in zip(idxs, self._collect_fused(handles)):
                    waves[i] = w
            in_flight = []
            for idxs in batches:
                tokens_list, do_post = m._prepare_tokens(
                    [text_input[i] for i in idxs], vowelizer,
                    postprocess_mel)
                in_flight.append((idxs, self._dispatch_fused(
                    tokens_list, do_post, _subset_speakers(speaker_id, idxs),
                    denoise, pad_to=bs, out_int16=out_int16,
                    generator=generator)))
                if len(in_flight) > WINDOW:
                    collect_fused(in_flight.pop(0))
            for item in in_flight:
                collect_fused(item)
            return waves

        def collect(item):
            idxs, (tokens_list, do_post), (out, _, inverse) = item
            mels_b = m._finish_ttmel(
                out["mel_postnet"].cpu().numpy(),
                out["mel_lens"].cpu().numpy(),
                out["alignments"].cpu().numpy(), inverse, tokens_list,
                do_post, speed)
            wave, lens = self._dispatch_vocode(mels_b, denoise, out_int16)
            for j, (i, w) in enumerate(zip(idxs,
                                           self._split_waves(wave, lens))):
                waves[i] = w
                mels[i] = mels_b[j]

        in_flight = []
        for idxs in batches:
            prepared = m._prepare_tokens([text_input[i] for i in idxs],
                                         vowelizer, postprocess_mel)
            dec = m._dispatch_infer(prepared[0],
                                    _subset_speakers(speaker_id, idxs),
                                    pad_to=bs, generator=generator)
            in_flight.append((idxs, prepared, dec))
            if len(in_flight) > WINDOW:
                collect(in_flight.pop(0))
        for item in in_flight:
            collect(item)
        return (waves, mels) if return_mel else waves
