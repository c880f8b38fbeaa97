"""HiFi-GAN's discriminators and GAN losses for vocoder training (the
port's counterpart of the JAX package's `vocoder/discriminators.py`;
reference `vocoder/hifigan/models.py:139-293`):

- `PeriodDiscriminator`: 2D convs over the waveform folded by a period,
  [B, T] -> [B, 1, T/p, p] (NCHW; the JAX module folds to [B, T/p, p, 1])
- `ScaleDiscriminator`: seven grouped 1D convs and conv_post
- `MultiPeriodDiscriminator` (periods 2/3/5/7/11) and
  `MultiScaleDiscriminator` (3 scales, average-pooled between them)
- the feature-matching, LSGAN discriminator and generator losses

As in the JAX package the convs carry no weight norm or spectral norm, and
`width` scales every channel count (1.0 = the reference's), so tests can
train the recipe at toy size. Submodules take the flax module names
(`period_2.conv_0`, `scale_1.conv_post`), so `models.convert` maps one
tree onto the other by name.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
# ScaleDiscriminator's convs: (channels, kernel, stride, groups)
SCALE_SPEC = ((128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16),
              (512, 41, 4, 16), (1024, 41, 4, 16), (1024, 41, 1, 16),
              (1024, 5, 1, 1))


class PeriodDiscriminator(nn.Module):
    """2D conv stack over a period-folded waveform (`DiscriminatorP`,
    models.py:139-172): waveform [B, T] -> (score [B, N], 6 feature maps
    [B, C, H, p])."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 width: float = 1.0):
        super().__init__()
        self.period = period
        chans = [max(int(c * width), 1) for c in (32, 128, 512, 1024)]
        c_in = 1
        for i, ch in enumerate(chans):
            setattr(self, f"conv_{i}", nn.Conv2d(
                c_in, ch, (kernel_size, 1), (stride, 1), padding=(2, 0)))
            c_in = ch
        c_last = max(int(1024 * width), 1)
        self.conv_4 = nn.Conv2d(c_in, c_last, (kernel_size, 1),
                                padding=(2, 0))
        self.conv_post = nn.Conv2d(c_last, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor):
        B, T = x.shape
        p = self.period
        if T % p:
            pad = p - T % p
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
            T += pad
        x = x.reshape(B, 1, T // p, p)
        fmaps = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(B, -1), fmaps


class ScaleDiscriminator(nn.Module):
    """1D grouped-conv stack (`DiscriminatorS`, models.py:202-227):
    waveform [B, T] -> (score [B, N], 8 feature maps [B, C, T'])."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        c_in = 1
        for i, (c, k, s, g) in enumerate(SCALE_SPEC):
            ch = max(int(c * width), g)
            setattr(self, f"conv_{i}", nn.Conv1d(
                c_in, ch, k, s, padding=k // 2, groups=g))
            c_in = ch
        self.conv_post = nn.Conv1d(c_in, 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        x = x[:, None]
        fmaps = []
        for i in range(len(SCALE_SPEC)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.reshape(x.shape[0], -1), fmaps


def _run_pair(discs, y, y_hat, between=None):
    """Each discriminator on the real and the generated waveform ->
    (real scores, generated scores, real fmaps, generated fmaps)."""
    outs = ([], [], [], [])
    for i, d in enumerate(discs):
        if i > 0 and between is not None:
            y, y_hat = between(y), between(y_hat)
        s_r, f_r = d(y)
        s_g, f_g = d(y_hat)
        for out, v in zip(outs, (s_r, s_g, f_r, f_g)):
            out.append(v)
    return outs


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 width: float = 1.0):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            setattr(self, f"period_{p}", PeriodDiscriminator(p, width=width))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Real y and generated y_hat [B, T] -> (real scores, generated
        scores, real fmaps, generated fmaps), one entry per period."""
        return _run_pair([getattr(self, f"period_{p}") for p in self.periods],
                         y, y_hat)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """flax's avg_pool (4, stride 2, padding 2, the padding counted)."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2,
                        count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3, width: float = 1.0):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            setattr(self, f"scale_{i}", ScaleDiscriminator(width))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """As `MultiPeriodDiscriminator`, one entry per scale; scale i > 0
        reads the waveforms average-pooled i times."""
        return _run_pair([getattr(self, f"scale_{i}")
                          for i in range(self.n_scales)], y, y_hat, _pool)


def feature_loss(fmaps_r: List, fmaps_g: List) -> torch.Tensor:
    """Sum of L1 feature distances x2, the real maps detached
    (models.py:262-268)."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for r, g in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(r.detach() - g))
    return loss * 2.0


def discriminator_loss(real_scores: List, gen_scores: List):
    """LSGAN D loss (models.py:271-282) -> (loss, real terms, generated
    terms)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_scores, gen_scores):
        r = torch.mean((1.0 - dr) ** 2)
        g = torch.mean(dg ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(gen_scores: List):
    """LSGAN G loss (models.py:285-293) -> (loss, per-discriminator
    terms)."""
    loss = 0.0
    per = []
    for dg in gen_scores:
        term = torch.mean((1.0 - dg) ** 2)
        per.append(term)
        loss = loss + term
    return loss, per
