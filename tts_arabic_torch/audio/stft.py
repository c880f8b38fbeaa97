"""STFT/ISTFT for the spectral denoiser (torch counterparts of the JAX
package's `audio/stft.py`, with `torch.fft` in place of `jnp.fft`)."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mel import frame_signal


@functools.lru_cache(maxsize=16)
def hann(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window semantics), computed in
    float64 and rounded to float32 as the JAX package does. Made once per
    length and device: a copy from pageable host memory would first wait
    for everything queued on the device. Callers must not write to it."""
    w = np.hanning(win_length + 1)[:-1].astype(np.float32)
    return torch.from_numpy(w).to(device)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: int | None = None, center: bool = True) -> torch.Tensor:
    """Complex STFT [..., F, T] of x [..., T]. center=True reflect-pads
    n_fft // 2 on both sides."""
    window = hann(win_length or n_fft, x.device)
    if center:
        p = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (p, p), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    frames = frame_signal(x, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def _overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """Overlap-add [..., n_frames, frame_len] -> [..., out_len]."""
    n_frames, flen = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    total = (n_frames - 1) * hop + flen
    cols = frames.reshape(-1, n_frames, flen).transpose(1, 2)
    out = F.fold(cols, output_size=(1, total), kernel_size=(1, flen),
                 stride=(1, hop))
    out = out.reshape(*lead, total)
    if total < out_len:
        out = F.pad(out, (0, out_len - total))
    return out[..., :out_len]


def istft(spec: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
          win_length: int | None = None, center: bool = True,
          length: int | None = None, eps: float = 1e-11) -> torch.Tensor:
    """Inverse STFT of a complex spectrogram [..., F, T], normalized by the
    window envelope (floored at eps). center=True matches torch.istft."""
    win_length = win_length or n_fft
    window = hann(win_length, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = spec.shape[-1]
    full_len = n_fft + hop_length * (n_frames - 1)
    audio = _overlap_add(frames, hop_length, full_len)
    env = _overlap_add((window ** 2).expand(n_frames, win_length),
                       hop_length, full_len)
    audio = audio / torch.clamp(env, min=eps)
    pad = n_fft // 2 if center else (n_fft - hop_length) // 2
    audio = audio[..., pad: full_len - pad]
    if length is not None:
        audio = audio[..., :length]
    return audio
