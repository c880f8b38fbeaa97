"""FastPitch acoustic model, inference half (torch counterpart of the JAX
package's `models/fastpitch.py`): 6+6 FFT transformer encoder/decoder,
conv TemporalPredictors for log-duration / pitch / energy, pitch and energy
embeddings added to the encoder output, an interval-matmul length
regulator and a Linear mel projection.

Inference composes as `encode_infer` (text -> durations + conditioned
encoder state) and `decode` (length-regulate -> decoder -> mel), so the
pipeline can pick the decoder's mel bucket from the predicted lengths.
The soft aligner's weights are held (reference checkpoints load strictly);
its training forward comes with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .layers import (FFTransformer, TemporalPredictor, conv1d_same, linear)


@dataclasses.dataclass(frozen=True)
class FastPitchConfig:
    """Hyperparameters (reference `models/fastpitch/__init__.py:3-41`).
    Dropout rates are kept for checkpoint configs; inference ignores them."""
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


class ConvAttention(nn.Module):
    """Weights of the reference's soft mel<->text aligner (attention.py:
    85-223): key and query conv projections, and the Conv2d `attn_proj`
    it instantiates but never calls. Training-time only."""

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


class FastPitch(nn.Module):
    """The FastPitch network (inference). See module docstring."""

    def __init__(self, config: FastPitchConfig = FastPitchConfig()):
        super().__init__()
        c = self.config = config
        self.encoder = FFTransformer(
            c.enc_n_layers, c.enc_n_heads, c.d_model, c.enc_d_head,
            c.enc_filter_size, c.enc_kernel_size, embed_input=True,
            n_embed=c.n_symbols, padding_idx=c.padding_idx)
        self.decoder = FFTransformer(
            c.dec_n_layers, c.dec_n_heads, c.d_model, c.dec_d_head,
            c.dec_filter_size, c.dec_kernel_size)
        self.duration_predictor = TemporalPredictor(
            c.d_model, c.dur_filter_size, c.dur_kernel_size, c.dur_n_layers)
        self.pitch_predictor = TemporalPredictor(
            c.d_model, c.pitch_filter_size, c.pitch_kernel_size,
            c.pitch_n_layers, n_predictions=c.pitch_formants)
        self.pitch_emb = nn.Conv1d(c.pitch_formants, c.d_model,
                                   c.pitch_emb_kernel_size)
        if c.energy_conditioning:
            self.energy_predictor = TemporalPredictor(
                c.d_model, c.energy_filter_size, c.energy_kernel_size,
                c.energy_n_layers)
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
        sid = torch.full((batch_size,), int(speaker), dtype=torch.long,
                         device=self.proj.weight.device)
        emb = nn.functional.embedding(sid, self.speaker_emb.weight)
        return (emb[:, None, :] * self.config.speaker_emb_weight).to(dtype)

    def encode_infer(self, tokens: torch.Tensor, *, speaker: int = 0,
                     pitch_mul: float = 1.0, pitch_add: float = 0.0,
                     max_duration: float = 75.0) -> dict:
        """Text tokens [B, T] -> conditioned encoder state + durations
        (reference `FastPitch.infer` up to the length regulator,
        model.py:351-397). pitch_mul/pitch_add scale and shift the
        normalized pitch (the wrapper's `pitch_trf`, networks.py:38-42)."""
        dtype = self.proj.weight.dtype
        spk = self._speaker_vector(tokens.shape[0], speaker, dtype)
        enc_out, enc_mask = self.encoder(tokens, conditioning=spk)

        log_dur = self.duration_predictor(enc_out, enc_mask).squeeze(-1)
        dur_pred = torch.clamp(torch.exp(log_dur) - 1.0, 0.0, max_duration)
        dur_pred = torch.where(enc_mask, dur_pred, 0.0)

        pitch_pred = self.pitch_predictor(enc_out, enc_mask)  # [B, T, 1]
        pitch_pred = pitch_mul * pitch_pred + pitch_add
        # re-mask: a nonzero pitch_add would otherwise leak into real
        # frames through the k=3 pitch_emb conv
        pitch_pred = torch.where(enc_mask[..., None], pitch_pred, 0.0)
        enc_out = enc_out + conv1d_same(pitch_pred, self.pitch_emb)

        energy_pred = None
        if self.config.energy_conditioning:
            energy_pred = self.energy_predictor(enc_out,
                                                enc_mask).squeeze(-1)
            enc_out = enc_out + conv1d_same(energy_pred[..., None],
                                            self.energy_emb)
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
        dec_out, _ = self.decoder(regulated, seq_lens=dec_lens)
        return linear(dec_out, self.proj), dec_lens

    def infer(self, tokens: torch.Tensor, *, speaker: int = 0,
              pace: float = 1.0, max_frames: int = 2048,
              pitch_mul: float = 1.0, pitch_add: float = 0.0,
              max_duration: float = 75.0) -> dict:
        """Full inference (reference `infer`, model.py:351-409). Returns
        mel [B, max_frames, n_mel], mel_lens, dur_pred, pitch_pred,
        energy_pred."""
        enc = self.encode_infer(tokens, speaker=speaker, pitch_mul=pitch_mul,
                                pitch_add=pitch_add,
                                max_duration=max_duration)
        mel, mel_lens = self.decode(enc["enc_out"], enc["dur_pred"],
                                    max_frames, pace)
        return {"mel": mel, "mel_lens": mel_lens,
                "dur_pred": enc["dur_pred"],
                "pitch_pred": enc["pitch_pred"],
                "energy_pred": enc["energy_pred"]}
