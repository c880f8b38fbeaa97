"""Wav output and mu-law companding (the serving helpers of the JAX
package's `audio/io.py`)."""
from __future__ import annotations

import math

import numpy as np
import torch


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
