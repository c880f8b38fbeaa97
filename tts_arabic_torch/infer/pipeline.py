"""High-level TTS inference pipelines (torch counterpart of the JAX
package's `infer/pipeline.py`): `FastPitchTTS.ttmel()` and
`FastPitch2Wave.tts()`, accepting Arabic script or Buckwalter, str or list.

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

Entry points run on the card: `device=None` means "cuda" and raises when
there is no CUDA device; pass `device="cpu"` to run on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import text as text_frontend
from ..audio.io import mulaw_encode
from ..models.convert import fold_weight_norm, load_reference_pth, to_tensors
from ..models.fastpitch import FastPitch, FastPitchConfig
from ..models.layers import init_weights
from ..runtime.device import resolve_device
from ..vocoder import denoiser as denoiser_mod
from ..vocoder.hifigan import Generator, HiFiGANConfig, chunked_vocode

LOG_MEL_PAD = float(np.log(1e-5))  # log-mel floor = silence padding value

TEXT_BUCKET = 16
MEL_BUCKETS = (64, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _pick_mel_bucket(n: int) -> int:
    for b in MEL_BUCKETS:
        if n <= b:
            return b
    return _round_up(n, 1024)


def _pad_ids(ids_list: Sequence[np.ndarray], length: int) -> np.ndarray:
    out = np.zeros((len(ids_list), length), np.int64)
    for i, ids in enumerate(ids_list):
        out[i, : len(ids)] = ids
    return out


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

    checkpoint: a reference `.pth` (read with `weights_only=True`), or None
    for seeded random weights (tests and benchmarks)."""

    def __init__(self, checkpoint=None, config: FastPitchConfig | None = None,
                 arabic_in: bool = True, seed: int = 0,
                 strict_text: bool = False, device=None):
        """strict_text: False (default) drops tokens outside the symbol
        table (trailing punctuation); True raises the reference's KeyError
        on them."""
        self.device = resolve_device(device)
        self.arabic_in = arabic_in
        self.strict_text = strict_text
        self.phon_to_id = None
        sd = None
        if checkpoint is not None:
            sd, extras = load_reference_pth(checkpoint)
            if config is None and extras.get("config"):
                config = FastPitchConfig.from_reference_net_config(
                    extras["config"])
            if "symbols" in extras:
                self.phon_to_id = {p: i for i, p in
                                   enumerate(extras["symbols"])}
        self.config = config or FastPitchConfig()
        self.model = FastPitch(self.config)
        if sd is None:
            init_weights(self.model, seed)
        else:
            self.model.load_state_dict(to_tensors(sd), strict=True)
        self.model.to(self.device).eval()

    # -- text frontend -------------------------------------------------------

    def tokenize(self, utterance: str) -> np.ndarray:
        to_tokens = (text_frontend.arabic_to_tokens if self.arabic_in
                     else text_frontend.buckwalter_to_tokens)
        ids = text_frontend.tokens_to_ids(
            to_tokens(utterance, append_space=False), self.phon_to_id,
            strict=self.strict_text)
        return np.asarray(ids, np.int64)

    def tokenize_batch(self, batch: List[str]) -> List[np.ndarray]:
        return [self.tokenize(t) for t in batch]

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

    def _decode_fn(self, enc_out, durations, pace, *, max_frames):
        """Decode in enc_out's dtype; padding frames are set to the log-mel
        silence floor so the vocoder sees silence, not decoder noise."""
        mel, mel_lens = self.model.decode(enc_out, durations, max_frames,
                                          pace)
        frame_ids = torch.arange(max_frames, device=mel.device)[None, :, None]
        mel = torch.where(frame_ids < mel_lens[:, None, None], mel,
                          LOG_MEL_PAD)
        return mel, mel_lens

    def _encode_batch(self, ids_list, speaker_id, pitch_mul, pitch_add,
                      pad_to=None, speed=1.0):
        """Sort + pad + encode; returns (enc, inverse order, n_real). Batch
        rows are padded to `pad_to` with one-pad-token rows."""
        n_real = len(ids_list)
        lens = np.asarray([len(x) for x in ids_list])
        order = np.argsort(-lens)
        ids_sorted = [ids_list[i] for i in order]
        rows = pad_to if pad_to is not None else n_real
        if n_real < rows:
            ids_sorted += [np.zeros(1, np.int64)] * (rows - n_real)
        tokens = _pad_ids(ids_sorted, _round_up(max(int(lens.max()), 1),
                                                TEXT_BUCKET))
        tokens = torch.from_numpy(tokens).to(self.device)
        with _exact_f32():
            enc = self._encode_fn(tokens, float(pitch_mul), float(pitch_add),
                                  int(speaker_id), float(speed))
        return enc, np.argsort(order), n_real

    def _infer_batch_mel(self, ids_list, speed, speaker_id, pitch_mul,
                         pitch_add, pad_to=None):
        enc, inverse, _ = self._encode_batch(ids_list, speaker_id, pitch_mul,
                                             pitch_add, pad_to, speed)
        bucket = _pick_mel_bucket(int(enc["dec_len_max"]))
        with _exact_f32():
            mel, mel_lens = self._decode_fn(enc["enc_out"], enc["dur_pred"],
                                            float(speed), max_frames=bucket)
        return mel, mel_lens, inverse, bucket

    # -- public API ----------------------------------------------------------

    def ttmel_batch(self, batch: List[str], speed: float = 1.0,
                    speaker_id: int = 0, pitch_mul: float = 1.0,
                    pitch_add: float = 0.0, pad_to=None):
        mel, mel_lens, inverse, _ = self._infer_batch_mel(
            self.tokenize_batch(batch), speed, speaker_id, pitch_mul,
            pitch_add, pad_to)
        mel = mel.float().cpu().numpy()
        mel_lens = mel_lens.cpu().numpy()
        return [mel[i, : mel_lens[i]].T for i in inverse]  # [80, T] each

    def ttmel_single(self, utterance: str, **kw):
        return self.ttmel_batch([utterance], **kw)[0]

    def ttmel(self, text_input: Union[str, List[str]], speed: float = 1.0,
              speaker_id: int = 0, batch_size: int = 1,
              pitch_mul: float = 1.0, pitch_add: float = 0.0):
        kw = dict(speed=speed, speaker_id=speaker_id, pitch_mul=pitch_mul,
                  pitch_add=pitch_add)
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


class FastPitch2Wave:
    """End-to-end text -> waveform (reference `FastPitch2Wave` equivalent):
    FastPitch, HiFi-GAN and the spectral denoiser."""

    def __init__(self, model_sd_path=None, vocoder_sd=None,
                 vocoder_config=None, arabic_in: bool = True, config=None,
                 seed: int = 0, compute_dtype: torch.dtype | None = None,
                 strict_text: bool = False, device=None):
        """compute_dtype: torch.bfloat16 runs the decoder and the vocoder in
        bf16 (weights stay f32 in memory and are cast per call); encode and
        the denoiser stay f32. None = f32 throughout.

        vocoder_sd: a reference HiFi-GAN `.pth` (weight norm is folded at
        load); None gives seeded random weights (seed + 1)."""
        self.compute_dtype = compute_dtype
        self.model = FastPitchTTS(model_sd_path, config=config,
                                  arabic_in=arabic_in, seed=seed,
                                  strict_text=strict_text, device=device)
        self.device = self.model.device
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

    @property
    def sample_rate(self) -> int:
        return self.vocoder_config.sampling_rate

    @property
    def hop_length(self) -> int:
        return self.vocoder_config.hop_length

    def _wave_fn(self, enc_out, durations, denoise_strength, pace, *,
                 max_frames, use_denoiser, return_mel=False,
                 out_int16=False):
        m = self.model
        if self.compute_dtype is not None:
            enc_out = enc_out.to(self.compute_dtype)
        mel, mel_lens = m._decode_fn(enc_out, durations, pace,
                                     max_frames=max_frames)
        wave = chunked_vocode(self.vocoder, mel).float()
        if use_denoiser:
            wave = denoiser_mod.denoise(wave, self.bias_spec,
                                        denoise_strength)
        if out_int16 == "mulaw":
            wave = mulaw_encode(wave)
        elif out_int16:
            wave = (torch.clamp(wave, -1.0, 1.0) * 32767.0).to(torch.int16)
        mel = mel.float() if return_mel else None
        return wave, mel, mel_lens

    def _dispatch_encode(self, batch, speed, speaker_id, pitch_mul,
                         pitch_add, pad_to):
        m = self.model
        return m._encode_batch(m.tokenize_batch(batch), speaker_id,
                               pitch_mul, pitch_add, pad_to, speed)

    def _dispatch_wave(self, enc_handles, speed, denoise, return_mel,
                       out_int16=False, dec_len_max=None):
        """Mel bucket from the batch's longest predicted length, then decode
        + vocode (+ denoise) at that bucket; the wave is cropped on the
        device to the real lengths rounded up to _CROP_FRAMES, so the copy
        to the host skips most bucket padding."""
        enc, inverse, _ = enc_handles
        if dec_len_max is None:
            dec_len_max = int(enc["dec_len_max"])
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
        return wave, mel, mel_lens, inverse

    # crop granularity (frames) for device-side trims before the copy to
    # the host
    _CROP_FRAMES = 64

    def _collect_batch(self, handles, return_mel):
        """Copy to the host, crop per utterance, unsort."""
        wave, mel, mel_lens, inverse = handles
        wave = wave.cpu().numpy()
        lens = mel_lens.cpu().numpy()
        hop = self.hop_length
        waves = [wave[i, : lens[i] * hop] for i in inverse]
        if return_mel:
            mel = mel.cpu().numpy()
            return waves, [mel[i, : lens[i]].T for i in inverse]
        return waves

    def tts_batch(self, batch: List[str], speed: float = 1.0,
                  speaker_id: int = 0, denoise: float = 0.0,
                  pitch_mul: float = 1.0, pitch_add: float = 0.0,
                  return_mel: bool = False, pad_to=None,
                  out_int16: bool = False):
        enc = self._dispatch_encode(batch, speed, speaker_id, pitch_mul,
                                    pitch_add, pad_to)
        handles = self._dispatch_wave(enc, speed, denoise, return_mel,
                                      out_int16)
        return self._collect_batch(handles, return_mel)

    def tts_single(self, utterance: str, **kw):
        out = self.tts_batch([utterance], **kw)
        if kw.get("return_mel"):
            return out[0][0], out[1][0]
        return out[0]

    def warmup(self, batch_sizes=(2,), text_buckets=(16, 32),
               mel_buckets=(256, 512, 1024), denoise: float = 0.005,
               return_mel: bool = False, out_int16: bool = False):
        """Run each (batch size, text bucket, mel bucket) once on zero
        tokens, so the first request pays no kernel build or cuDNN
        algorithm search."""
        m = self.model
        for bs in batch_sizes:
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tts(self, text_input: Union[str, List[str]], speed: float = 1.0,
            denoise: float = 0.005, speaker_id: int = 0, batch_size: int = 2,
            pitch_mul: float = 1.0, pitch_add: float = 0.0,
            return_mel: bool = False, out_int16: bool = False):
        """Synthesize speech (API of reference `FastPitch2Wave.tts`,
        networks.py:352-435).

        Returns waveform(s) as numpy float32 [n_samples] at 22050 Hz.
        `out_int16`: False (float32) | True (int16) | "mulaw" (uint8
        G.711-style codes, companded on the device; decode with
        `audio.mulaw_decode`)."""
        kw = dict(speed=speed, denoise=denoise, speaker_id=speaker_id,
                  pitch_mul=pitch_mul, pitch_add=pitch_add,
                  return_mel=return_mel, out_int16=out_int16)
        if isinstance(text_input, str):
            return self.tts_single(text_input, **kw)
        # global length sort before batching, so batches are homogeneous in
        # length and bucket padding stays small
        order = sorted(range(len(text_input)),
                       key=lambda i: -len(text_input[i]))
        bs = max(batch_size, 1)
        batches = [order[k: k + bs] for k in range(0, len(order), bs)]
        # every encode is queued before the one host fetch of the bucket
        # scalars; every wave is queued before the first copy back
        encs = [self._dispatch_encode([text_input[i] for i in idxs], speed,
                                      speaker_id, pitch_mul, pitch_add,
                                      pad_to=bs)
                for idxs in batches]
        maxes = torch.stack([e[0]["dec_len_max"] for e in encs]).tolist()
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
