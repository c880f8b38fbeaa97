"""Analytic FLOP counts of the synthesis models, for model FLOPs
utilization (MFU = achieved FLOP/s / the card's peak FLOP/s); the port's
copy of the JAX package's `eval/flops.py`.

Counts multiply-accumulates as 2 FLOPs, matmul/conv terms only
(elementwise ops are bound by bytes, not FLOPs). Shapes follow the
reference models the configs mirror: FastPitch
(`models/fastpitch/fastpitch/model.py`), HiFi-GAN
(`vocoder/hifigan/models.py:86-136`), Vocos (`vocoder/vocos/models.py` +
ISTFT head), Tacotron2 (`models/tacotron2/tacotron2_ms.py`).
"""
from __future__ import annotations

import math

from ..models.fastpitch import FastPitchConfig
from ..models.tacotron2 import Tacotron2Config
from ..vocoder.hifigan import HiFiGANConfig, generator_flops_per_frame


def fft_stack_flops(T: int, n_layers: int, d_model: int, n_heads: int,
                    d_head: int, filter_size: int, kernel_size: int) -> int:
    """One FFT-transformer stack (MHA + conv-k FFN) over a length-T row."""
    attn = (2 * T * d_model * 3 * n_heads * d_head      # fused qkv
            + 2 * T * T * n_heads * d_head              # scores
            + 2 * T * T * n_heads * d_head              # context
            + 2 * T * n_heads * d_head * d_model)       # out projection
    ffn = (2 * T * kernel_size * d_model * filter_size
           + 2 * T * kernel_size * filter_size * d_model)
    return n_layers * (attn + ffn)


def _predictor_flops(T: int, d_model: int, filter_size: int,
                     n_layers: int, kernel_size: int) -> int:
    f = 2 * T * kernel_size * d_model * filter_size
    f += (n_layers - 1) * 2 * T * kernel_size * filter_size * filter_size
    return f + 2 * T * filter_size  # fc head


def fastpitch_encode_flops(cfg: FastPitchConfig, n_tokens: int) -> int:
    """Phase A (encode_infer) FLOPs for one row of n_tokens."""
    T = n_tokens
    f = fft_stack_flops(T, cfg.enc_n_layers, cfg.d_model, cfg.enc_n_heads,
                        cfg.enc_d_head, cfg.enc_filter_size,
                        cfg.enc_kernel_size)
    f += _predictor_flops(T, cfg.d_model, cfg.dur_filter_size,
                          cfg.dur_n_layers, cfg.dur_kernel_size)
    f += _predictor_flops(T, cfg.d_model, cfg.pitch_filter_size,
                          cfg.pitch_n_layers, cfg.pitch_kernel_size)
    f += 2 * T * cfg.pitch_emb_kernel_size * cfg.pitch_formants * cfg.d_model
    if cfg.energy_conditioning:
        f += _predictor_flops(T, cfg.d_model, cfg.energy_filter_size,
                              cfg.energy_n_layers, cfg.energy_kernel_size)
        f += 2 * T * cfg.energy_emb_kernel_size * cfg.d_model
    return f


def fastpitch_decode_flops(cfg: FastPitchConfig, n_tokens: int,
                           n_frames: int) -> int:
    """Phase B (decode): length regulator + decoder FFT + mel projection."""
    F = n_frames
    f = 2 * F * n_tokens * cfg.d_model  # interval-matmul length regulator
    f += fft_stack_flops(F, cfg.dec_n_layers, cfg.d_model, cfg.dec_n_heads,
                         cfg.dec_d_head, cfg.dec_filter_size,
                         cfg.dec_kernel_size)
    return f + 2 * F * cfg.d_model * cfg.n_mel_channels


def hifigan_flops(n_frames: int,
                  cfg: HiFiGANConfig = HiFiGANConfig()) -> int:
    return n_frames * generator_flops_per_frame(cfg)


def vocos_flops(n_frames: int, dim: int = 512, intermediate_dim: int = 1536,
                num_layers: int = 8, n_mels: int = 80,
                n_fft: int = 1024) -> int:
    """MelVocos backbone + ISTFT head per n_frames (CONFIG_22K dims)."""
    per_frame = 2 * 7 * n_mels * dim                         # embed conv k7
    per_frame += num_layers * (2 * 7 * dim                   # depthwise k7
                               + 2 * dim * intermediate_dim  # pwconv1
                               + 2 * intermediate_dim * dim)  # pwconv2
    per_frame += 2 * dim * (n_fft + 2)                        # head linear
    # irfft (split-radix real FFT ~ 2.5 N log2 N) + overlap-add window
    per_frame += int(2.5 * n_fft * math.log2(n_fft)) + 2 * n_fft
    return n_frames * per_frame


def tacotron2_flops(cfg: Tacotron2Config, n_tokens: int,
                    n_steps: int) -> int:
    """Encoder + n_steps autoregressive decoder steps + postnet, one row.

    The while_loop decode runs every step at full batch width until the
    longest row finishes, so callers should pass the executed step count
    (mel bucket), not the per-sample mel length.
    """
    T, S = n_tokens, n_steps
    e = cfg.encoder_embedding_dim
    # encoder: 3 convs k5 e->e + BiLSTM (2 dirs, hidden e/2)
    f = cfg.encoder_n_convolutions * 2 * T * cfg.encoder_kernel_size * e * e
    f += 2 * 2 * T * (e + e // 2) * 4 * (e // 2)
    mem = cfg.memory_dim
    ah = cfg.attention_hidden_dim
    # static memory/key projection for attention
    f += 2 * T * mem * ah
    # per decode step
    step = 2 * (cfg.n_mels * cfg.prenet_dim
                + cfg.prenet_dim * cfg.prenet_dim)          # prenet
    step += 2 * (cfg.prenet_dim + mem
                 + cfg.attention_rnn_dim) * 4 * cfg.attention_rnn_dim
    step += 2 * cfg.attention_rnn_dim * ah                  # query proj
    step += 2 * T * (cfg.attention_location_kernel_size * 2
                     * cfg.attention_location_n_filters     # location conv
                     + cfg.attention_location_n_filters * ah  # location proj
                     + ah                                   # energies v
                     + mem)                                 # context matmul
    step += 2 * (cfg.attention_rnn_dim + mem
                 + cfg.decoder_rnn_dim) * 4 * cfg.decoder_rnn_dim
    step += 2 * (cfg.decoder_rnn_dim + mem) * (cfg.n_mels + 1)  # mel + gate
    f += S * step
    # postnet: 5 convs k5 (n_mels->p, 3x p->p, p->n_mels)
    p, k = cfg.postnet_embedding_dim, cfg.postnet_kernel_size
    f += 2 * S * k * (cfg.n_mels * p
                      + (cfg.postnet_n_convolutions - 2) * p * p
                      + p * cfg.n_mels)
    return f


# Dense peak FLOP/s of one card by `torch.cuda.get_device_name()`, per
# dtype: NVIDIA's H100 SXM data sheet (dense, no sparsity) at its full
# 700 W power limit; the H100 80GB HBM3 these numbers are used on reads
# "NVIDIA H100 80GB HBM3, 700.00 W" from `nvidia-smi --query-gpu=name,
# power.limit`. A card set below 700 W peaks lower.
_PEAK_FLOPS = {
    "NVIDIA H100": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
                    "fp32": 67e12},
}


def chip_peak_flops(device=None, dtype: str = "bf16") -> float | None:
    """Peak FLOP/s of the card `device` (an index or torch device; None:
    the current one) in `dtype` ("bf16", "fp16", "tf32" or "fp32"), by
    `torch.cuda.get_device_name`; None when the card is not in the
    table."""
    import torch
    name = torch.cuda.get_device_name(device)
    for prefix, peaks in _PEAK_FLOPS.items():
        if name.startswith(prefix):
            return peaks.get(dtype)
    return None
