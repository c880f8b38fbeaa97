"""Signal framing and the host-side log-mel frontend (the parts of the JAX
package's `audio/mel.py` that the inference path and the training
datasets use).

Analysis parameters as the reference (`utils/audio.py:6-46`): 22050 Hz,
n_fft = win_length = 1024, hop 256, 80 mel bands, fmin 0 / fmax 8000,
slaney mel scale with slaney area normalization, reflect padding of
(n_fft - hop)/2 on both ends, center=False STFT, magnitude
sqrt(|S|^2 + 1e-9), log clamped at 1e-5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# --- Slaney mel scale -------------------------------------------------------

_F_SP = 200.0 / 3.0          # Hz per mel below the break point
_MIN_LOG_HZ = 1000.0         # break point between linear and log regions
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # step size in the log region


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop: int) -> torch.Tensor:
    """Slice [..., T] into overlapping frames [..., n_frames, frame_length]
    (a strided view, no copy)."""
    return x.unfold(-1, frame_length, hop)


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mel = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    return np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, 1e-10) / _MIN_LOG_HZ)
        / _LOGSTEP,
        mel)


def mel_to_hz(mel):
    mel = np.asanyarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    return np.where(
        log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)),
        freq)


def slaney_mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                          fmin: float = 0.0,
                          fmax: float | None = None) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2 + 1] with slaney area
    normalization, equivalent to librosa.filters.mel(htk=False) (reference
    `utils/audio.py:27-30`)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 22050
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0

    @property
    def pad_length(self) -> int:
        return (self.n_fft - self.hop_length) // 2


def log_mel_numpy(x: np.ndarray, cfg: MelConfig = MelConfig()) -> np.ndarray:
    """Waveform [T] -> log-mel [n_mels, frames] in numpy, for host-side
    dataset loading (`utils/data.py:150-151`)."""
    basis = slaney_mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                  cfg.f_min, cfg.f_max)
    window = np.hanning(cfg.win_length + 1)[:-1].astype(np.float32)
    pad = cfg.pad_length
    xp = np.pad(x, pad, mode="reflect")
    n_frames = 1 + (len(xp) - cfg.n_fft) // cfg.hop_length
    idx = (np.arange(n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.n_fft)[None, :])
    spec = np.fft.rfft(xp[idx] * window, n=cfg.n_fft, axis=-1)
    mag = np.sqrt(np.abs(spec) ** 2 + 1e-9).T  # [F, T]
    return np.log(np.clip(basis @ mag, 1e-5, None)).astype(np.float32)
