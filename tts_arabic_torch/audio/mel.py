"""Signal framing, the mel filterbanks (slaney, and HTK for Vocos), the
host-side log-mel frontend and the device log-mel (the JAX package's
`audio/mel.py`): numpy for the datasets, torch for vocoder training, which
takes the log-mel of the waveform batch and of the generator's output
inside the step and differentiates through the second.

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
import torch.nn.functional as F

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


def hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + np.asanyarray(freq, np.float64) / 700.0)


def mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asanyarray(mel, np.float64) / 2595.0) - 1.0)


def slaney_mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                          fmin: float = 0.0, fmax: float | None = None,
                          norm: str | None = "slaney",
                          htk: bool = False) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2 + 1]: with the defaults
    slaney's scale and area normalization, equivalent to
    librosa.filters.mel(htk=False) (reference `utils/audio.py:27-30`);
    htk=True, norm=None gives torchaudio's default HTK filterbank (Vocos's
    `MelSpectrogramFeatures`, feature_extractors.py:28-64)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    to_mel, to_hz = ((hz_to_mel_htk, mel_to_hz_htk) if htk
                     else (hz_to_mel, mel_to_hz))
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz_pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


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


# --- torch device path (vocoder training) -----------------------------------

_CONSTANTS: dict = {}


def _constants(cfg: MelConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The Slaney basis [n_mels, n_fft//2 + 1] and the periodic Hann window
    [win_length], made once per config and device."""
    key = (cfg, torch.device(device))
    if key not in _CONSTANTS:
        basis = slaney_mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                      cfg.f_min, cfg.f_max)
        window = np.hanning(cfg.win_length + 1)[:-1].astype(np.float32)
        _CONSTANTS[key] = (torch.from_numpy(basis).to(device),
                           torch.from_numpy(window).to(device))
    return _CONSTANTS[key]


def stft_magnitude(x: torch.Tensor, cfg: MelConfig = MelConfig()
                   ) -> torch.Tensor:
    """Waveform [..., S] -> linear magnitude [..., n_fft//2 + 1, frames],
    center=False after reflect-padding (n_fft - hop)/2 on each side, so S
    samples give S/hop frames. |X|^2 is formed as re^2 + im^2, which has a
    finite gradient where X = 0."""
    _, window = _constants(cfg, x.device)
    pad = cfg.pad_length
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = frame_signal(xp.reshape(*lead, -1), cfg.n_fft,
                          cfg.hop_length) * window.to(x.dtype)
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.transpose(-1, -2)


def mel_spectrogram(x: torch.Tensor, cfg: MelConfig = MelConfig()
                    ) -> torch.Tensor:
    """Waveform [..., S] -> mel magnitude [..., n_mels, frames]."""
    basis, _ = _constants(cfg, x.device)
    return basis.to(x.dtype) @ stft_magnitude(x, cfg)


def log_mel_spectrogram(x: torch.Tensor, cfg: MelConfig = MelConfig(),
                        clip: float = 1e-5) -> torch.Tensor:
    """Log-mel as the datasets consume it (`utils/data.py:150-151`),
    differentiable: waveform [..., S] -> [..., n_mels, S/hop]."""
    return torch.log(torch.clamp(mel_spectrogram(x, cfg), min=clip))


class MelSpectrogram:
    """Callable wrapper mirroring the reference `MelSpectrogram` module:
    waveform [..., S] -> mel magnitude [..., n_mels, frames]."""

    def __init__(self, **kwargs):
        self.config = MelConfig(**kwargs)

    def __call__(self, x) -> torch.Tensor:
        return mel_spectrogram(torch.as_tensor(x), self.config)
