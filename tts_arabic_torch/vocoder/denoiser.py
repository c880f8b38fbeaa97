"""Spectral denoiser for vocoder bias removal (torch counterpart of the JAX
package's `vocoder/denoiser.py`; reference `Denoiser`,
`vocoder/hifigan/denoiser.py:40-72`).

The vocoder's bias spectrum is the magnitude spectrum of the first STFT
frame of the generator's output for a zero mel (1 x 88 x 80); at inference
the scaled bias is subtracted from the waveform's magnitude spectrum
(clamped at 0) and the signal is resynthesized with the original phase.
Both run in float32.
"""
from __future__ import annotations

import torch

from ..audio.stft import istft, stft

_N_FFT = 1024
_HOP = 256


def compute_bias_spec(generator, n_mels: int = 80, n_frames: int = 88,
                      device=None) -> torch.Tensor:
    """Bias magnitude spectrum [n_fft // 2 + 1] from a zero-mel generator
    pass in float32."""
    zero_mel = torch.zeros((1, n_frames, n_mels), dtype=torch.float32,
                           device=device)
    bias_audio = generator(zero_mel)  # [1, T]
    spec = stft(bias_audio, _N_FFT, _HOP, center=True)
    return torch.abs(spec)[0, :, 0]


def denoise(audio: torch.Tensor, bias_spec: torch.Tensor,
            strength: float) -> torch.Tensor:
    """audio [B, T] f32 -> denoised [B, T]."""
    spec = stft(audio, _N_FFT, _HOP, center=True)
    mag = torch.clamp(torch.abs(spec) - strength * bias_spec[None, :, None],
                      min=0.0)
    clean = torch.polar(mag, torch.angle(spec))
    return istft(clean, _N_FFT, _HOP, center=True, length=audio.shape[-1])
