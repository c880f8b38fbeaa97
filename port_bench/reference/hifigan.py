"""The HiFi-GAN generator in plain float32 PyTorch (jik876/hifi-gan
`models.py`, weight norm folded), from a state dict in the published
layout, and the published spectral denoiser
(`vocoder/hifigan/denoiser.py` of nipponjo/tts-arabic-pytorch) on
`torch.stft`.

`h` is the published generator config (`config_v1.json`'s keys).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1
N_FFT, HOP = 1024, 256


def hop_length(h: dict) -> int:
    out = 1
    for r in h["upsample_rates"]:
        out *= r
    return out


def param_specs(h: dict) -> list[tuple]:
    """(name, shape, init) of every state-dict entry (see
    `fastpitch.param_specs`); the transposed convs' weights have std
    0.01, as the published init draws them; every bias has the variance
    of PyTorch's default uniform bias, which the published init keeps
    (std 1/sqrt(3 fan in), the fan in of a transposed conv being its
    output channels times its kernel)."""
    out = []
    ch = h["upsample_initial_channel"]

    def conv(name, o, i, k):
        out.append((f"{name}.weight", (o, i, k), ("normal", (i * k) ** -0.5)))
        out.append((f"{name}.bias", (o,), ("normal", (3 * i * k) ** -0.5)))

    conv("conv_pre", ch, h["num_mels"], 7)
    n = 0
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        c_out = h["upsample_initial_channel"] // 2 ** (i + 1)
        out.append((f"ups.{i}.weight", (ch, c_out, k), ("normal", 0.01)))
        out.append((f"ups.{i}.bias", (c_out,),
                    ("normal", (3 * c_out * k) ** -0.5)))
        for rk, rd in zip(h["resblock_kernel_sizes"],
                          h["resblock_dilation_sizes"]):
            for j in range(len(rd)):
                conv(f"resblocks.{n}.convs1.{j}", c_out, c_out, rk)
            for j in range(len(rd)):
                conv(f"resblocks.{n}.convs2.{j}", c_out, c_out, rk)
            n += 1
        ch = c_out
    conv("conv_post", 1, ch, 7)
    return out


def _conv(x, sd, name, dilation=1):
    w = sd[f"{name}.weight"]
    return F.conv1d(x, w, sd[f"{name}.bias"], dilation=dilation,
                    padding=dilation * (w.shape[-1] - 1) // 2)


def generate(sd: dict, h: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [frames, num_mels] -> wave [frames * hop]."""
    x = _conv(mel.t()[None], sd, "conv_pre")
    n_k = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = F.conv_transpose1d(x, sd[f"ups.{i}.weight"], sd[f"ups.{i}.bias"],
                               stride=u, padding=(k - u) // 2)
        acc = 0.0
        for j, dils in enumerate(h["resblock_dilation_sizes"]):
            name = f"resblocks.{i * n_k + j}"
            y = x
            for m, d in enumerate(dils):
                t = _conv(F.leaky_relu(y, LRELU_SLOPE), sd,
                          f"{name}.convs1.{m}", d)
                y = y + _conv(F.leaky_relu(t, LRELU_SLOPE), sd,
                              f"{name}.convs2.{m}")
            acc = acc + y
        x = acc / n_k
    x = _conv(F.leaky_relu(x, 0.01), sd, "conv_post")
    return torch.tanh(x)[0, 0]


def _window(device) -> torch.Tensor:
    return torch.hann_window(N_FFT, periodic=True, dtype=torch.float32,
                             device=device)


def bias_spectrum(sd: dict, h: dict) -> torch.Tensor:
    """The magnitude of the first STFT frame of the generator's output
    for a zero mel of 88 frames [n_fft // 2 + 1]."""
    dev = sd["conv_pre.weight"].device
    wave = generate(sd, h, torch.zeros(88, h["num_mels"], device=dev))
    spec = torch.stft(wave, N_FFT, HOP, window=_window(dev), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.abs()[:, 0]


def denoise(wave: torch.Tensor, bias: torch.Tensor,
            strength: float) -> torch.Tensor:
    """The bias spectrum times `strength` taken off the magnitude (not
    below 0), resynthesized with the original phase."""
    win = _window(wave.device)
    spec = torch.stft(wave, N_FFT, HOP, window=win, center=True,
                      pad_mode="reflect", return_complex=True)
    mag = torch.clamp(spec.abs() - strength * bias[:, None], min=0.0)
    return torch.istft(torch.polar(mag, spec.angle()), N_FFT, HOP,
                       window=win, center=True, length=wave.shape[-1])
