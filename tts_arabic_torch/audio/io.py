"""Wav input and output, resampling and mu-law companding (the serving and
dataset helpers of the JAX package's `audio/io.py`)."""
from __future__ import annotations

import math

import numpy as np
import torch


def load_wav(path, target_sr: int | None = None):
    """Read a wav as float32 in [-1, 1] (multichannel downmixed);
    optionally resample. Returns (wave, sample_rate)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    if target_sr is not None and sr != target_sr:
        x = resample(x, sr, target_sr)
        sr = target_sr
    return x, sr


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling by the reduced ratio target_sr / orig_sr."""
    from scipy.signal import resample_poly
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def save_wav(path, x, sample_rate: int = 22050):
    """Write a float waveform in [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile
    x = np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    wavfile.write(path, sample_rate, (x * 32767.0).astype(np.int16))


def mulaw_encode(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """f32 waveform in [-1, 1] -> uint8 mu-law codes (G.711-style
    companding), on the tensor's device, so the pipeline moves a quarter of
    the f32 bytes to the host. Decode with `mulaw_decode`."""
    x = torch.clamp(x, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)
    return torch.round((y + 1.0) * (mu / 2.0)).to(torch.uint8)


def mulaw_decode(codes, mu: int = 255) -> np.ndarray:
    """uint8 mu-law codes -> f32 waveform in [-1, 1] (host-side inverse of
    `mulaw_encode`)."""
    y = np.asarray(codes, np.float32) * (2.0 / mu) - 1.0
    out = np.sign(y) * (np.expm1(np.abs(y) * np.log1p(mu))) / mu
    return out.astype(np.float32)
