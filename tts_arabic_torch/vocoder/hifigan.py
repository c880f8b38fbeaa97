"""HiFi-GAN vocoder: mel [B, T, 80] -> waveform [B, T*256] (torch
counterpart of the JAX package's `vocoder/hifigan.py`).

conv_pre k7 -> 4 stages of [leaky-relu -> transposed-conv upsample (rates
8, 8, 2, 2) -> multi-receptive-field fusion of 3 ResBlocks (k 3/7/11,
dilations 1/3/5) averaged] -> leaky-relu -> conv_post k7 -> tanh
(reference `vocoder/hifigan/models.py:86-136`).

Activations stay feature-last [B, T, C] between stages. Every ResBlock1
runs through `ops.resblock.resblock1`, the hand-written CUDA kernel on a
CUDA tensor; conv_pre, the upsamples and conv_post stay `F.conv1d` /
`F.conv_transpose1d`, as the JAX package leaves them to XLA. Parameter
names follow the reference state dict with weight norm folded (the
reference removes it at load, `vocoder/__init__.py:19`). Weights are cast
to the input's dtype at each call, so one f32 module serves bf16 too.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import conv1d_same
from ..ops.resblock import LRELU_SLOPE, resblock1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    @classmethod
    def from_json(cls, path) -> "HiFiGANConfig":
        with open(path) as f:
            h = json.load(f)
        return cls(
            resblock=str(h.get("resblock", "1")),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in h["resblock_dilation_sizes"]),
            num_mels=h.get("num_mels", 80),
            sampling_rate=h.get("sampling_rate", 22050),
        )


def conv_transpose_1d(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, stride: int,
                      padding: int) -> torch.Tensor:
    """torch ConvTranspose1d on feature-last x [B, T, C_in] with a reference
    weight [C_in, C_out, k] -> [B, (T-1)*stride - 2*padding + k, C_out]."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight.to(x.dtype),
                           bias.to(x.dtype), stride=stride, padding=padding)
    return y.transpose(1, 2)


class ResBlock1(nn.Module):
    """Dilated residual block (reference `ResBlock1`, models.py:22-59):
    three [leaky -> dilated conv -> leaky -> conv -> add] passes, one
    `resblock1` kernel call."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size) for _ in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] contiguous -> [B, T, C]."""
        stack = lambda convs, attr: torch.stack(  # noqa: E731
            [getattr(c, attr) for c in convs])
        return resblock1(x, stack(self.convs1, "weight"),
                         stack(self.convs1, "bias"),
                         stack(self.convs2, "weight"),
                         stack(self.convs2, "bias"), self.kernel_size,
                         self.dilations)


class ResBlock2(nn.Module):
    """2-conv variant (reference `ResBlock2`, models.py:62-79), in plain
    PyTorch: no TPU kernel covers it either."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, d in zip(self.convs, self.dilations):
            x = x + conv1d_same(F.leaky_relu(x, LRELU_SLOPE), conv, d)
        return x


class Generator(nn.Module):
    def __init__(self, config: HiFiGANConfig = HiFiGANConfig()):
        super().__init__()
        c = self.config = config
        res_cls = ResBlock1 if c.resblock == "1" else ResBlock2
        ch = c.upsample_initial_channel
        self.conv_pre = nn.Conv1d(c.num_mels, ch, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(c.upsample_rates,
                                       c.upsample_kernel_sizes)):
            ch_out = c.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(ch, ch_out, k, u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(c.resblock_kernel_sizes,
                              c.resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch_out, rk, rd))
            ch = ch_out
        self.conv_post = nn.Conv1d(ch, 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, num_mels] -> waveform [B, T*hop], in mel's dtype."""
        c = self.config
        n_k = len(c.resblock_kernel_sizes)
        x = conv1d_same(mel, self.conv_pre)
        for i, up in enumerate(self.ups):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = conv_transpose_1d(x, up.weight, up.bias, up.stride[0],
                                  up.padding[0]).contiguous()
            acc = None
            for j in range(n_k):
                y = self.resblocks[i * n_k + j](x)
                acc = y if acc is None else acc + y
            x = acc / n_k
        # final activation uses torch's default 0.01 slope in the reference
        # (models.py:123)
        x = F.leaky_relu(x, 0.01)
        x = conv1d_same(x, self.conv_post)
        return torch.tanh(x).squeeze(-1)


def chunked_vocode(generator: Callable[[torch.Tensor], torch.Tensor],
                   mel: torch.Tensor, *, core: int = 480, overlap: int = 16,
                   slab: int = 64, direct_limit: int = 65536) -> torch.Tensor:
    """Memory-bounded vocoding of long or batched mels by overlap-discard.

    mel [B, F, n_mels] -> wave [B, F*hop], equal to vocoding the full mel in
    one call: the generator's receptive field is ~+-13 mel frames, so with
    `overlap` >= 16 every chunk core reproduces the full call, and windows
    are clamped to the sequence ends so the edges see the generator's own
    zero padding.

    Three paths: one call when F fits one window (core + 2 * overlap) or
    B*F <= direct_limit (halved for f32); else
    batch groups of direct_limit // F rows when a row fits; else time
    chunks of `core` frames, vocoded `slab` chunks per call.

    direct_limit is sized for an 80 GB card: the last stage holds about six
    [B, 256*F, 32] activations at once, ~100 KB per frame in bf16, so
    65536 frames take ~6.5 GB and leave room for a second batch in flight.
    """
    B, F_, C = mel.shape
    window = core + 2 * overlap
    if mel.element_size() >= 4:
        direct_limit //= 2
    if F_ <= window or B * F_ <= direct_limit:
        return generator(mel)

    group = direct_limit // F_
    if group >= 1:
        return torch.cat([generator(mel[g: g + group])
                          for g in range(0, B, group)], dim=0)

    n_chunks = -(-F_ // core)
    # clamp windows into [0, F - window]; cores stay aligned to i*core
    starts = np.clip(np.arange(n_chunks) * core - overlap, 0, F_ - window)
    core_off = np.arange(n_chunks) * core - starts
    idx = torch.as_tensor(starts[:, None] + np.arange(window)[None, :],
                          device=mel.device)
    chunks = mel[:, idx, :].reshape(B * n_chunks, window, C)
    waves = torch.cat([generator(chunks[s: s + slab])
                       for s in range(0, B * n_chunks, slab)], dim=0)
    hop = waves.shape[-1] // window
    waves = waves.reshape(B, n_chunks, window * hop)

    # each chunk's own core offset: a window clamped at either end moves
    # its core off `overlap`, and near the ends interior chunks clamp too
    # (whenever (n_chunks - 1) * core + overlap > F, or core < overlap)
    parts = []
    for i, off in enumerate(core_off.tolist()):
        n = min(core, F_ - i * core)
        parts.append(waves[:, i, off * hop: (off + n) * hop])
    return torch.cat(parts, dim=-1)
