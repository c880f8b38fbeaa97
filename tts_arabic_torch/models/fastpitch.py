"""FastPitch acoustic model (torch counterpart of the JAX package's
`models/fastpitch.py`): 6+6 FFT transformer encoder/decoder, conv
TemporalPredictors for log-duration / pitch / energy, pitch and energy
embeddings added to the encoder output, an interval-matmul length
regulator and a Linear mel projection.

Inference composes as `encode_infer` (text -> durations + conditioned
encoder state) and `decode` (length-regulate -> decoder -> mel), so the
pipeline can pick the decoder's mel bucket from the predicted lengths.
Training runs `align_attention` (the ConvAttention soft aligner), MAS on
its output (`align.mas_durations`, the CUDA kernel on the card), then
`forward_train` with the hard durations, as the JAX train step does.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .layers import (FFTransformer, TemporalPredictor, conv1d_same, linear)

# LJSpeech's pitch mean and std: what `pitch_transform` is given when a
# checkpoint stores no corpus statistics (reference model.py:376)
PITCH_MEAN_FALLBACK = 218.14
PITCH_STD_FALLBACK = 67.24


@dataclasses.dataclass(frozen=True)
class FastPitchConfig:
    """Hyperparameters (reference `models/fastpitch/__init__.py:3-41`).
    The dropout rates apply in training only (`forward_train` with a
    generator)."""
    n_mel_channels: int = 80
    n_symbols: int = 40
    padding_idx: int = 0
    d_model: int = 384
    enc_n_layers: int = 6
    enc_n_heads: int = 1
    enc_d_head: int = 64
    enc_kernel_size: int = 3
    enc_filter_size: int = 1536
    enc_dropout: float = 0.1
    enc_dropatt: float = 0.1
    enc_dropemb: float = 0.0
    dec_n_layers: int = 6
    dec_n_heads: int = 1
    dec_d_head: int = 64
    dec_kernel_size: int = 3
    dec_filter_size: int = 1536
    dec_dropout: float = 0.1
    dec_dropatt: float = 0.1
    dec_dropemb: float = 0.0
    dur_filter_size: int = 256
    dur_kernel_size: int = 3
    dur_dropout: float = 0.1
    dur_n_layers: int = 2
    pitch_filter_size: int = 256
    pitch_kernel_size: int = 3
    pitch_dropout: float = 0.1
    pitch_n_layers: int = 2
    pitch_emb_kernel_size: int = 3
    pitch_formants: int = 1
    energy_conditioning: bool = True
    energy_filter_size: int = 256
    energy_kernel_size: int = 3
    energy_dropout: float = 0.1
    energy_n_layers: int = 2
    energy_emb_kernel_size: int = 3
    n_speakers: int = 1
    speaker_emb_weight: float = 1.0
    attn_channels: int = 80

    @classmethod
    def from_reference_net_config(cls, net_config: dict) -> "FastPitchConfig":
        """Map a reference-style `net_config` dict (the layout embedded in
        its checkpoints) onto this config."""
        m = _REF_NET_CONFIG_KEYMAP
        return cls(**{m[k]: v for k, v in net_config.items() if k in m})

    def to_reference_net_config(self) -> dict:
        return {ref_k: getattr(self, our_k)
                for ref_k, our_k in _REF_NET_CONFIG_KEYMAP.items()}


_REF_NET_CONFIG_KEYMAP = {
    "n_mel_channels": "n_mel_channels",
    "n_symbols": "n_symbols",
    "padding_idx": "padding_idx",
    "symbols_embedding_dim": "d_model",
    "in_fft_n_layers": "enc_n_layers",
    "in_fft_n_heads": "enc_n_heads",
    "in_fft_d_head": "enc_d_head",
    "in_fft_conv1d_kernel_size": "enc_kernel_size",
    "in_fft_conv1d_filter_size": "enc_filter_size",
    "p_in_fft_dropout": "enc_dropout",
    "p_in_fft_dropatt": "enc_dropatt",
    "p_in_fft_dropemb": "enc_dropemb",
    "out_fft_n_layers": "dec_n_layers",
    "out_fft_n_heads": "dec_n_heads",
    "out_fft_d_head": "dec_d_head",
    "out_fft_conv1d_kernel_size": "dec_kernel_size",
    "out_fft_conv1d_filter_size": "dec_filter_size",
    "p_out_fft_dropout": "dec_dropout",
    "p_out_fft_dropatt": "dec_dropatt",
    "p_out_fft_dropemb": "dec_dropemb",
    "dur_predictor_kernel_size": "dur_kernel_size",
    "dur_predictor_filter_size": "dur_filter_size",
    "p_dur_predictor_dropout": "dur_dropout",
    "dur_predictor_n_layers": "dur_n_layers",
    "pitch_predictor_kernel_size": "pitch_kernel_size",
    "pitch_predictor_filter_size": "pitch_filter_size",
    "p_pitch_predictor_dropout": "pitch_dropout",
    "pitch_predictor_n_layers": "pitch_n_layers",
    "pitch_embedding_kernel_size": "pitch_emb_kernel_size",
    "energy_conditioning": "energy_conditioning",
    "energy_predictor_kernel_size": "energy_kernel_size",
    "energy_predictor_filter_size": "energy_filter_size",
    "p_energy_predictor_dropout": "energy_dropout",
    "energy_predictor_n_layers": "energy_n_layers",
    "energy_embedding_kernel_size": "energy_emb_kernel_size",
    "n_speakers": "n_speakers",
    "speaker_emb_weight": "speaker_emb_weight",
}


def regulate_len(durations: torch.Tensor, enc_out: torch.Tensor,
                 max_frames: int, pace: float = 1.0):
    """Expand encoder states by integer durations (reference `regulate_len`,
    model.py:68-90) to a fixed output length.

    durations: [B, T] float; enc_out: [B, T, C]. Returns (expanded
    [B, max_frames, C], dec_lens [B] int32). Frame f copies token t iff
    cs[t] <= f < cs[t+1], cs the cumsum of the rounded durations; the copy
    is one matmul with that 0/1 matrix, as in the JAX package (exact: each
    frame sums one token's state)."""
    reps = torch.floor(durations / pace + 0.5).to(torch.int32)
    dec_lens = reps.sum(dim=1, dtype=torch.int32)
    cs = torch.cumsum(nn.functional.pad(reps, (1, 0)), dim=1)   # [B, T+1]
    frames = torch.arange(max_frames, device=durations.device)[None, :, None]
    mult = (cs[:, None, :-1] <= frames) & (cs[:, None, 1:] > frames)
    out = torch.matmul(mult.to(enc_out.dtype), enc_out)
    return out, torch.clamp(dec_lens, max=max_frames)


class _ConvNorm(nn.Module):
    """Reference `ConvNorm` (a Conv1d under `.conv`)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size)


def average_by_durations(values: torch.Tensor,
                         durations: torch.Tensor) -> torch.Tensor:
    """Average frame-level values over each token's duration span
    (reference `average_pitch`, model.py:93-111).

    values: [B, n_formants, T_mel] (zeros are excluded from the average);
    durations: [B, T_text]. Returns [B, n_formants, T_text]."""
    ends = torch.cumsum(durations, dim=1).to(torch.long)
    starts = nn.functional.pad(ends[:, :-1], (1, 0))
    nonzero_cums = nn.functional.pad(
        torch.cumsum((values != 0.0).to(values.dtype), dim=2), (1, 0))
    value_cums = nn.functional.pad(torch.cumsum(values, dim=2), (1, 0))

    def gather(c, idx):
        return torch.gather(c, 2, idx[:, None, :].expand(-1, c.shape[1], -1))

    sums = gather(value_cums, ends) - gather(value_cums, starts)
    counts = gather(nonzero_cums, ends) - gather(nonzero_cums, starts)
    return torch.where(counts == 0.0, 0.0,
                       sums / torch.clamp(counts, min=1.0))


class ConvAttention(nn.Module):
    """The reference's soft mel<->text aligner (attention.py:85-223): conv
    projections of both streams, negative-L2 Gaussian log-likelihood
    scores, the beta-binomial prior in log space, masked softmax over the
    text axis. Holds the Conv2d `attn_proj` the reference instantiates but
    never calls, so its checkpoints load strictly. Layout feature-last."""

    def __init__(self, n_mel_channels: int = 80, n_text_channels: int = 384,
                 n_att_channels: int = 80):
        super().__init__()
        self.key_proj = nn.Sequential(
            _ConvNorm(n_text_channels, 2 * n_text_channels, 3), nn.ReLU(),
            _ConvNorm(2 * n_text_channels, n_att_channels, 1))
        self.query_proj = nn.Sequential(
            _ConvNorm(n_mel_channels, 2 * n_mel_channels, 3), nn.ReLU(),
            _ConvNorm(2 * n_mel_channels, n_mel_channels, 1), nn.ReLU(),
            _ConvNorm(n_mel_channels, n_att_channels, 1))
        self.attn_proj = nn.Conv2d(n_att_channels, 1, kernel_size=1)

    def forward(self, mels: torch.Tensor, text_emb: torch.Tensor,
                text_mask: torch.Tensor, attn_prior=None):
        """mels [B, T_mel, n_mel], text_emb [B, T_txt, C], text_mask
        [B, T_txt] bool. Returns (attn [B, T_mel, T_txt] softmaxed over the
        text axis, attn_logprob of the same shape)."""
        k = conv1d_same(text_emb, self.key_proj[0].conv)
        k = conv1d_same(torch.relu(k), self.key_proj[2].conv)
        q = conv1d_same(mels, self.query_proj[0].conv)
        q = conv1d_same(torch.relu(q), self.query_proj[2].conv)
        q = conv1d_same(torch.relu(q), self.query_proj[4].conv)
        # -0.0005 * ||q_f - k_t||^2, expanded so the cross term is a matmul
        q2 = torch.sum(q ** 2, dim=-1)[:, :, None]
        k2 = torch.sum(k ** 2, dim=-1)[:, None, :]
        qk = torch.matmul(q, k.transpose(1, 2))
        scores = -0.0005 * (q2 + k2 - 2.0 * qk)
        if attn_prior is not None:
            scores = (torch.log_softmax(scores, dim=2)
                      + torch.log(attn_prior + 1e-8))
        attn_logprob = scores
        scores = scores.masked_fill(~text_mask[:, None, :], float("-inf"))
        return torch.softmax(scores, dim=2), attn_logprob


class FastPitch(nn.Module):
    """The FastPitch network. See module docstring."""

    def __init__(self, config: FastPitchConfig = FastPitchConfig()):
        super().__init__()
        c = self.config = config
        self.encoder = FFTransformer(
            c.enc_n_layers, c.enc_n_heads, c.d_model, c.enc_d_head,
            c.enc_filter_size, c.enc_kernel_size, embed_input=True,
            n_embed=c.n_symbols, padding_idx=c.padding_idx,
            dropout=c.enc_dropout, dropatt=c.enc_dropatt,
            dropemb=c.enc_dropemb)
        self.decoder = FFTransformer(
            c.dec_n_layers, c.dec_n_heads, c.d_model, c.dec_d_head,
            c.dec_filter_size, c.dec_kernel_size, dropout=c.dec_dropout,
            dropatt=c.dec_dropatt, dropemb=c.dec_dropemb)
        self.duration_predictor = TemporalPredictor(
            c.d_model, c.dur_filter_size, c.dur_kernel_size, c.dur_n_layers,
            dropout=c.dur_dropout)
        self.pitch_predictor = TemporalPredictor(
            c.d_model, c.pitch_filter_size, c.pitch_kernel_size,
            c.pitch_n_layers, n_predictions=c.pitch_formants,
            dropout=c.pitch_dropout)
        self.pitch_emb = nn.Conv1d(c.pitch_formants, c.d_model,
                                   c.pitch_emb_kernel_size)
        if c.energy_conditioning:
            self.energy_predictor = TemporalPredictor(
                c.d_model, c.energy_filter_size, c.energy_kernel_size,
                c.energy_n_layers, dropout=c.energy_dropout)
            self.energy_emb = nn.Conv1d(1, c.d_model,
                                        c.energy_emb_kernel_size)
        if c.n_speakers > 1:
            self.speaker_emb = nn.Embedding(c.n_speakers, c.d_model)
        self.proj = nn.Linear(c.d_model, c.n_mel_channels)
        self.attention = ConvAttention(c.n_mel_channels, c.d_model,
                                       c.attn_channels)
        # corpus pitch statistics (reference registered buffers,
        # model.py:213-214)
        self.register_buffer("pitch_mean", torch.zeros(1))
        self.register_buffer("pitch_std", torch.zeros(1))

    def _speaker_vector(self, batch_size: int, speaker: int, dtype):
        if self.config.n_speakers <= 1:
            return 0.0
        if isinstance(speaker, torch.Tensor):   # a device scalar
            sid = speaker.to(torch.long).expand(batch_size)
        else:
            sid = torch.full((batch_size,), int(speaker), dtype=torch.long,
                             device=self.proj.weight.device)
        emb = nn.functional.embedding(sid, self.speaker_emb.weight)
        return (emb[:, None, :] * self.config.speaker_emb_weight).to(dtype)

    def encode_infer(self, tokens: torch.Tensor, *, speaker: int = 0,
                     pitch_mul: float = 1.0, pitch_add: float = 0.0,
                     pitch_tgt: torch.Tensor | None = None,
                     energy_tgt: torch.Tensor | None = None,
                     max_duration: float = 75.0,
                     pitch_transform=None) -> dict:
        """Text tokens [B, T] -> conditioned encoder state + durations
        (reference `FastPitch.infer` up to the length regulator,
        model.py:351-397). pitch_mul/pitch_add scale and shift the
        normalized pitch (the wrapper's `pitch_trf`, networks.py:38-42).
        `pitch_transform(pitch [B, T, 1], enc_lens [B], mean, std) -> pitch`
        is the general hook (model.py:373-380), given the stored corpus
        pitch statistics (LJSpeech's 218.14/67.24 when the checkpoint has
        none, std == 0) and applied before the mul/add. `pitch_tgt` and
        `energy_tgt` [B, T, 1] replace the predictions in the embeddings;
        the returned `pitch_pred` stays the predictor's, and with
        `energy_tgt` no energy is predicted (`energy_pred` None), as in
        the JAX package."""
        dtype = self.proj.weight.dtype
        spk = self._speaker_vector(tokens.shape[0], speaker, dtype)
        enc_out, enc_mask = self.encoder(tokens, conditioning=spk)

        log_dur = self.duration_predictor(enc_out, enc_mask).squeeze(-1)
        dur_pred = torch.clamp(torch.exp(log_dur) - 1.0, 0.0, max_duration)
        dur_pred = torch.where(enc_mask, dur_pred, 0.0)

        pitch_pred = self.pitch_predictor(enc_out, enc_mask)  # [B, T, 1]
        if pitch_transform is not None:
            has_stats = self.pitch_std[0] != 0.0
            mean = torch.where(has_stats, self.pitch_mean[0],
                               PITCH_MEAN_FALLBACK)
            std = torch.where(has_stats, self.pitch_std[0],
                              PITCH_STD_FALLBACK)
            pitch_pred = pitch_transform(pitch_pred, enc_mask.sum(dim=1),
                                         mean, std)
        pitch_pred = pitch_mul * pitch_pred + pitch_add
        # re-mask: a nonzero pitch_add would otherwise leak into real
        # frames through the k=3 pitch_emb conv
        pitch_pred = torch.where(enc_mask[..., None], pitch_pred, 0.0)
        enc_out = enc_out + conv1d_same(
            pitch_pred if pitch_tgt is None else pitch_tgt, self.pitch_emb)

        energy_pred = None
        if self.config.energy_conditioning:
            if energy_tgt is None:
                energy_pred = self.energy_predictor(enc_out,
                                                    enc_mask).squeeze(-1)
                energy_tgt = energy_pred[..., None]
            enc_out = enc_out + conv1d_same(energy_tgt, self.energy_emb)
        return {
            "enc_out": enc_out,
            "enc_mask": enc_mask,
            "dur_pred": dur_pred,
            "pitch_pred": pitch_pred.transpose(1, 2),
            "energy_pred": energy_pred,
        }

    def decode(self, enc_out: torch.Tensor, durations: torch.Tensor,
               max_frames: int, pace: float = 1.0):
        """Length-regulate + decoder FFT + mel projection, in enc_out's
        dtype. Returns (mel [B, max_frames, n_mel], dec_lens [B])."""
        regulated, dec_lens = regulate_len(durations, enc_out, max_frames,
                                           pace)
        return self.decode_regulated(regulated, dec_lens), dec_lens

    def decode_regulated(self, regulated: torch.Tensor,
                         dec_lens: torch.Tensor) -> torch.Tensor:
        """Decoder FFT + mel projection of length-regulated states
        [B, frames, d_model] with their lengths dec_lens [B]."""
        dec_out, _ = self.decoder(regulated, seq_lens=dec_lens)
        return linear(dec_out, self.proj)

    def infer(self, tokens: torch.Tensor, *, speaker: int = 0,
              pace: float = 1.0, max_frames: int = 2048,
              pitch_mul: float = 1.0, pitch_add: float = 0.0,
              dur_tgt: torch.Tensor | None = None,
              pitch_tgt: torch.Tensor | None = None,
              energy_tgt: torch.Tensor | None = None,
              max_duration: float = 75.0, pitch_transform=None) -> dict:
        """Full inference (reference `infer`, model.py:351-409); `dur_tgt`
        [B, T] replaces the predicted durations in the length regulator,
        the other targets as in `encode_infer`. Returns mel [B, max_frames,
        n_mel], mel_lens, dur_pred, pitch_pred, energy_pred."""
        enc = self.encode_infer(tokens, speaker=speaker, pitch_mul=pitch_mul,
                                pitch_add=pitch_add, pitch_tgt=pitch_tgt,
                                energy_tgt=energy_tgt,
                                max_duration=max_duration,
                                pitch_transform=pitch_transform)
        mel, mel_lens = self.decode(
            enc["enc_out"], enc["dur_pred"] if dur_tgt is None else dur_tgt,
            max_frames, pace)
        return {"mel": mel, "mel_lens": mel_lens,
                "dur_pred": enc["dur_pred"],
                "pitch_pred": enc["pitch_pred"],
                "energy_pred": enc["energy_pred"]}

    # ---- training ----------------------------------------------------------

    def forward_train(self, tokens, token_lens, mel_tgt, mel_lens,
                      pitch_dense, energy_dense, attn_prior, attn_hard_dur,
                      *, speaker=None, use_gt_pitch: bool = True,
                      max_duration: float = 75.0,
                      gen: torch.Generator | None = None) -> dict:
        """Teacher-forced training forward (reference `forward`,
        model.py:273-349), in the JAX package's split: MAS is not in here.
        The caller computes the soft attention with `align_attention`, runs
        MAS on it and passes the hard durations `attn_hard_dur` [B, T_txt]
        back in (no gradient flows through them).

        mel_tgt [B, T_mel, n_mel] (feature-last); pitch_dense [B, 1, T_mel];
        energy_dense [B, T_mel]; attn_prior [B, T_mel, T_txt]. `gen` draws
        the dropout masks (None: no dropout). Returns a dict of everything
        the losses need. `speaker` (an int or an int tensor [B]) adds the
        speaker embedding; the pitch embedding takes the target pitch
        (teacher forcing, the reference's training forward) unless
        `use_gt_pitch` is False, the energy embedding always the target."""
        c = self.config
        spk = (0.0 if speaker is None else
               self._speaker_vector(tokens.shape[0], speaker,
                                    self.proj.weight.dtype))
        enc_out, enc_mask = self.encoder(tokens, conditioning=spk, gen=gen)

        log_dur_pred = self.duration_predictor(enc_out, enc_mask,
                                               gen).squeeze(-1)
        dur_pred = torch.clamp(torch.exp(log_dur_pred) - 1.0, 0.0,
                               max_duration)
        pitch_pred = self.pitch_predictor(enc_out, enc_mask,
                                          gen).transpose(1, 2)  # [B, 1, T]

        # soft alignment for the aligner losses
        text_emb = self.encoder.embed_tokens(tokens)
        attn_soft, attn_logprob = self.attention(mel_tgt, text_emb, enc_mask,
                                                 attn_prior)

        dur_tgt = attn_hard_dur.detach()
        pitch_tgt = average_by_durations(pitch_dense, dur_tgt)
        enc_out = enc_out + conv1d_same(
            (pitch_tgt if use_gt_pitch else pitch_pred).transpose(1, 2),
            self.pitch_emb)

        energy_pred = energy_tgt = None
        if c.energy_conditioning:
            energy_pred = self.energy_predictor(enc_out, enc_mask,
                                                gen).squeeze(-1)
            energy_tgt = torch.log1p(average_by_durations(
                energy_dense[:, None, :], dur_tgt))
            enc_out = enc_out + conv1d_same(energy_tgt.transpose(1, 2),
                                            self.energy_emb)
            energy_tgt = energy_tgt.squeeze(1)

        regulated, dec_lens = regulate_len(dur_tgt, enc_out,
                                           mel_tgt.shape[1])
        dec_out, dec_mask = self.decoder(regulated, seq_lens=dec_lens,
                                         gen=gen)
        return {
            "mel_out": linear(dec_out, self.proj),
            "dec_mask": dec_mask,
            "dur_pred": dur_pred,
            "log_dur_pred": log_dur_pred,
            "dur_tgt": dur_tgt,
            "pitch_pred": pitch_pred,
            "pitch_tgt": pitch_tgt,
            "energy_pred": energy_pred,
            "energy_tgt": energy_tgt,
            "attn_soft": attn_soft,
            "attn_logprob": attn_logprob,
        }

    def align_attention(self, tokens, mel_tgt, attn_prior):
        """Soft attention only (the train step's MAS input): (attn_soft,
        attn_logprob), each [B, T_mel, T_txt]."""
        text_emb = self.encoder.embed_tokens(tokens)
        enc_mask = tokens != self.config.padding_idx
        return self.attention(mel_tgt, text_emb, enc_mask, attn_prior)
