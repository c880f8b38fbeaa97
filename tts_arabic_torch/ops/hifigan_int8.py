"""Static-calibrated int8 serving path for the HiFi-GAN MRF stages (torch
counterpart of the JAX package's `ops/hifigan_int8.py`).

An opt-in post-training-quantized generator:

- weights are quantized per output channel (symmetric int8) from the
  unchanged float module, once per weight (`ops.int8.gemm_weight`);
- activations are quantized on per-conv-site static scales calibrated once
  from representative mels (`collect_mrf_scales`);
- only the MRF ResBlock convs of stages of at least `min_ch` channels run
  int8 (`ops.int8.int8_conv_static`); residual adds, leaky-relus, the
  upsamples, conv_pre/post and every narrower stage stay as
  `vocoder.hifigan.Generator` runs them, the narrow stages on the
  ResBlock CUDA kernel.

Sites are named `s{stage}b{block}c{conv}d{di}`: HiFi-GAN V1 at the default
min_ch = 64 has 3 stages x 3 blocks x 3 dilations x 2 convs = 54.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .int8 import int8_conv_static
from .resblock import LRELU_SLOPE


def _site(stage: int, block: int, conv: int, di: int) -> str:
    return f"s{stage}b{block}c{conv}d{di}"


class _HookedMRF:
    """ResBlock1 forward with every conv routed through `self.conv(site, y,
    conv, dilation)`; claims the stages of width >= min_ch. The base of
    both the calibration pass and the int8 pass, so the calibrated sites
    and the quantized sites are the same by construction."""

    def __init__(self, min_ch: int):
        if min_ch <= 32:
            raise ValueError(
                f"min_ch={min_ch}: int8 claims stages of at least 64 "
                "channels; the narrower ones stay on the narrow ResBlock "
                "kernel")
        self.min_ch = min_ch

    def claims(self, ch: int) -> bool:
        return ch >= self.min_ch

    def __call__(self, x: torch.Tensor, block, *, stage: int,
                 index: int) -> torch.Tensor:
        """x [B, T, C] through `block` (a `ResBlock1`) -> [B, T, C]."""
        for di, d in enumerate(block.dilations):
            y = F.leaky_relu(x, LRELU_SLOPE)
            y = self.conv(_site(stage, index, 1, di), y, block.convs1[di], d)
            y = F.leaky_relu(y, LRELU_SLOPE)
            y = self.conv(_site(stage, index, 2, di), y, block.convs2[di], 1)
            x = x + y
        return x


class _StatsMRF(_HookedMRF):
    """Calibration pass: records the max-abs of every claimed conv's input
    (on the device, max-reduced across calls) and convolves in float."""

    def __init__(self, min_ch: int):
        super().__init__(min_ch)
        self.stats: Dict[str, torch.Tensor] = {}

    def conv(self, site, y, conv, dilation):
        amax = y.float().abs().max()
        self.stats[site] = (torch.maximum(self.stats[site], amax)
                            if site in self.stats else amax)
        k = conv.weight.shape[-1]
        out = F.conv1d(y.transpose(1, 2), conv.weight.to(y.dtype),
                       conv.bias.to(y.dtype), dilation=dilation,
                       padding=dilation * (k - 1) // 2)
        return out.transpose(1, 2)


class _Int8MRF(_HookedMRF):
    def __init__(self, scales: Dict[str, float], min_ch: int):
        super().__init__(min_ch)
        self.scales = scales

    def conv(self, site, y, conv, dilation):
        return int8_conv_static(y, conv.weight, conv.bias, dilation,
                                self.scales[site])


def check_stages(config, min_ch: int = 64) -> None:
    """Raise ValueError unless min_ch > 32 and some MRF stage of a HiFi-GAN
    config (`vocoder.hifigan.HiFiGANConfig`) is min_ch channels wide or
    more: the checks `collect_mrf_scales` makes, without running the
    generator."""
    _HookedMRF(min_ch)
    widths = [config.upsample_initial_channel // 2 ** (i + 1)
              for i in range(len(config.upsample_rates))]
    if max(widths) < min_ch:
        raise ValueError("no MRF stage reaches min_ch channels "
                         f"(min_ch={min_ch}, stage widths {widths})")


@torch.no_grad()
def collect_mrf_scales(generator, mels, min_ch: int = 64,
                       margin: float = 1.0) -> Dict[str, float]:
    """Calibrate the static activation scales of `generator_apply_int8`.

    mels: one [B, T, n_mels] tensor or a list of them, in the dtype the
    serving path runs. Returns {site: ascale} python floats, max(amax,
    1e-12) * margin / 127; margin > 1 leaves headroom above the calibrated
    max-abs (beyond it the input clips symmetrically)."""
    if isinstance(mels, torch.Tensor):
        mels = [mels]
    hook = _StatsMRF(min_ch)
    for m in mels:
        generator(m, resblock_override=hook)
    if not hook.stats:
        raise ValueError("no MRF stage reaches min_ch channels")
    return {k: max(float(v), 1e-12) * margin / 127.0
            for k, v in hook.stats.items()}


def generator_apply_int8(generator, mel: torch.Tensor,
                         scales: Dict[str, float], *,
                         min_ch: int = 64) -> torch.Tensor:
    """`generator(mel)` with the claimed MRF stages in static int8
    (`scales` from `collect_mrf_scales`)."""
    return generator(mel, resblock_override=_Int8MRF(scales, min_ch))
