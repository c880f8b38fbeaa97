"""HiFi-GAN vocoder: mel [B, T, 80] -> waveform [B, T*256] (torch
counterpart of the JAX package's `vocoder/hifigan.py`).

conv_pre k7 -> 4 stages of [leaky-relu -> transposed-conv upsample (rates
8, 8, 2, 2) -> multi-receptive-field fusion of 3 ResBlocks (k 3/7/11,
dilations 1/3/5) averaged] -> leaky-relu -> conv_post k7 -> tanh
(reference `vocoder/hifigan/models.py:86-136`).

Activations stay feature-last [B, T, C] between stages. Every ResBlock1
runs through `ops.resblock.resblock1`, the hand-written CUDA kernel on a
CUDA tensor; conv_pre, the upsamples and conv_post stay `F.conv1d` /
`F.conv_transpose1d`, as the JAX package leaves them to XLA. On the card
the ResBlocks of one stage run side by side, each on a stream of its own
(`_side_streams`): a short window fills a tenth of the SMs with one
ResBlock's time tiles. While a gradient is recorded (training), they run in
turn on the caller's stream and each goes through `ResBlock1Function`
(the kernel's forward, a plain recompute in the backward). Parameter
names follow the reference state dict with weight norm folded (the
reference removes it at load, `vocoder/__init__.py:19`). Weights are cast
to the input's dtype at each call, so one f32 module serves bf16 too.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import conv1d_same
from ..ops.resblock import (LRELU_SLOPE, kernel_weights, resblock1,
                            resblock1_op)

# per device, the streams a stage's ResBlocks run on (made at first use)
_STREAMS: dict = {}


def _side_streams(device: torch.device, n: int) -> list:
    streams = _STREAMS.setdefault(device, [])
    while len(streams) < n:
        streams.append(torch.cuda.Stream(device))
    return streams[:n]


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
    `resblock1` kernel call (through `ResBlock1Function` while a gradient
    is recorded)."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: Sequence[int]):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size) for _ in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size) for _ in dilations)
        self._cache = None
        self._baked = {}

    def bake(self, dtype: torch.dtype) -> None:
        """Make the weights an exported program reads, once: stacked, the
        convs' weights in the kernel layout in `dtype`. Under
        `torch.export` the block calls the op `tts_arabic::resblock1` on
        them, and the program keeps them as constants."""
        with torch.no_grad():
            w1, b1, w2, b2 = self._stacks()
            self._baked[dtype] = (kernel_weights(w1, dtype), b1,
                                  kernel_weights(w2, dtype), b2)

    def _stacks(self) -> tuple:
        """The convs' weights and biases stacked per pass (w1, b1, w2, b2),
        kept while no parameter changes and no gradient is recorded: the
        same tensors come back call after call, so `resblock1` can keep
        their kernel layout too."""
        params = list(self.parameters())
        recording = (torch.is_grad_enabled()
                     and any(p.requires_grad for p in params))
        key = tuple((p.data_ptr(), p._version) for p in params)
        if (not recording and self._cache is not None
                and self._cache[0] == key):
            return self._cache[1]
        stack = lambda convs, attr: torch.stack(  # noqa: E731
            [getattr(c, attr) for c in convs])
        out = (stack(self.convs1, "weight"), stack(self.convs1, "bias"),
               stack(self.convs2, "weight"), stack(self.convs2, "bias"))
        self._cache = None if recording else (key, out)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] contiguous -> [B, T, C]."""
        if torch.compiler.is_exporting():
            if x.dtype not in self._baked:
                raise RuntimeError(f"export needs ResBlock1.bake({x.dtype}) "
                                   "first")
            return resblock1_op(x, *self._baked[x.dtype], self.kernel_size,
                                list(self.dilations))
        return resblock1(x, *self._stacks(), self.kernel_size,
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

    def forward(self, mel: torch.Tensor,
                resblock_override=None) -> torch.Tensor:
        """mel [B, T, num_mels] -> waveform [B, T*hop], in mel's dtype.

        resblock_override: a hook with `claims(channels) -> bool` and
        `__call__(x, block, stage=, index=) -> y` (JAX
        `generator_apply_pallas(..., resblock_override=)`): the MRF
        ResBlocks of a stage whose width it claims run through it
        (`ops.hifigan_int8`); the other stages run as they do without
        one."""
        c = self.config
        n_k = len(c.resblock_kernel_sizes)
        x = conv1d_same(mel, self.conv_pre)
        for i, up in enumerate(self.ups):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = conv_transpose_1d(x, up.weight, up.bias, up.stride[0],
                                  up.padding[0]).contiguous()
            blocks = self.resblocks[i * n_k: (i + 1) * n_k]
            if (resblock_override is not None
                    and resblock_override.claims(x.shape[-1])):
                blocks = [functools.partial(resblock_override, block=b,
                                            stage=i, index=j)
                          for j, b in enumerate(blocks)]
            x = self._fuse(blocks, x)
        # final activation uses torch's default 0.01 slope in the reference
        # (models.py:123)
        x = F.leaky_relu(x, 0.01)
        x = conv1d_same(x, self.conv_post)
        return torch.tanh(x).squeeze(-1)

    @staticmethod
    def _fuse(blocks, x: torch.Tensor) -> torch.Tensor:
        """Multi-receptive-field fusion: the outputs of the blocks
        (callables on x), summed in order and averaged. On the card, while
        no gradient is recorded, block 0 runs on the caller's stream and
        block j > 0 on side stream j, forked from it and joined back before
        the sum. The last block (k = 11 in the published configs, the
        longest) is queued first, for when the host is behind. Every
        allocation on a side stream happens after such a fork, so a block
        the caller freed is reused there only after the caller's last read
        of it; no `record_stream` is needed. That no longer holds once
        autograd keeps saved tensors and runs backward nodes on the
        forward's streams, so a recorded call runs the blocks in turn on
        the caller's stream (a training batch fills the card with one
        block's tiles anyway)."""
        recording = torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for b in blocks if isinstance(b, nn.Module)
            for p in b.parameters()))
        if x.device.type != "cuda" or recording:
            ys = [block(x) for block in blocks]
        else:
            main = torch.cuda.current_stream(x.device)
            streams = _side_streams(x.device, len(blocks) - 1)
            fork = main.record_event()
            ys = [None] * len(blocks)
            for j in reversed(range(1, len(blocks))):
                streams[j - 1].wait_event(fork)
                with torch.cuda.stream(streams[j - 1]):
                    ys[j] = blocks[j](x)
            ys[0] = blocks[0](x)
            for side in streams:
                main.wait_event(side.record_event())
        acc = ys[0]
        for y in ys[1:]:
            acc = acc + y
        return acc / len(blocks)


def generator_flops_per_frame(config: HiFiGANConfig = HiFiGANConfig()) -> int:
    """FLOPs of one generator forward per mel frame, 2 per multiply-add of
    conv_pre, the upsamples, the MRF ResBlocks and conv_post (JAX
    `generator_flops_per_frame`)."""
    c = config
    total = 7 * c.num_mels * c.upsample_initial_channel
    t_mult = 1
    ch_in = c.upsample_initial_channel
    for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
        ch = c.upsample_initial_channel // (2 ** (i + 1))
        t_mult *= u
        total += t_mult * k * ch_in * ch // u
        for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
            total += t_mult * 2 * len(rd) * rk * ch * ch
        ch_in = ch
    total += t_mult * 7 * ch_in
    return 2 * total


# HiFi-GAN's reach, in mel frames, with room: a sample depends on the mel
# up to ~13 frames either side (the generator's receptive field), and the
# denoiser's centred STFT reads under 3 more. So a window or a group that
# carries VOCODE_MARGIN frames past those it keeps gives them as the whole
# call does: `chunked_vocode`'s overlap, the pipeline's `stream()` windows,
# and length-grouped vocoding (`length_groups`, `grouped_vocode`), where a
# group runs at its longest row + VOCODE_MARGIN, rounded up to VOCODE_STEP
VOCODE_MARGIN = 16
VOCODE_STEP = 64
# the cost of one more generator call, in frames of a row's work: of 0,
# 256, 512, 768 and 1024, the fastest offline batch synthesis with HiFi-GAN
# V1 in bf16 on an H100 (0 and 256 alike; 256 cuts fewer groups)
VOCODE_CALL_FRAMES = 256


def length_groups(lens: Sequence[int], bucket: int) -> list:
    """Cut a batch's rows, whose mels are decoded at `bucket` frames and
    whose own frames are `lens`, into groups vocoded apart:
    [(row indices, frames)]. Rows are ordered by their frame count and cut
    into contiguous runs; a run is vocoded at its longest row +
    VOCODE_MARGIN rounded up to VOCODE_STEP, at most `bucket`. The cut
    minimises the frames vocoded plus VOCODE_CALL_FRAMES a group, so rows
    of one length make one group, and rows near the bucket one group at
    it."""
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    frames = [min(-(-(lens[i] + VOCODE_MARGIN) // VOCODE_STEP) * VOCODE_STEP,
                  bucket) for i in order]
    # cost[b]: the least cost of the first b rows; start[b]: where the
    # last group of that cut starts
    cost, start = [0] + [None] * len(order), [0] * (len(order) + 1)
    for b in range(1, len(order) + 1):
        for a in range(b):
            c = cost[a] + (b - a) * frames[a] + VOCODE_CALL_FRAMES
            if cost[b] is None or c < cost[b]:
                cost[b], start[b] = c, a
    groups, b = [], len(order)
    while b:
        a = start[b]
        groups.append((sorted(order[a:b]), frames[a]))
        b = a
    return groups[::-1]


def _rows(rows: list, device: torch.device):
    """An index of these rows (ascending): a slice when they are
    contiguous, else a tensor on `device`, copied from pinned memory on the
    card so that the copy does not wait for the device's queue."""
    if rows[-1] - rows[0] + 1 == len(rows):
        return slice(rows[0], rows[-1] + 1)
    index = torch.tensor(rows)
    if device.type == "cuda":
        index = index.pin_memory().to(device, non_blocking=True)
    return index


def grouped_vocode(generator: Callable[[torch.Tensor], torch.Tensor],
                   mel: torch.Tensor, groups: list) -> torch.Tensor:
    """mel [B, F, n_mels] -> f32 wave [B, F*hop]: each group (rows, frames)
    of `length_groups` vocoded through `chunked_vocode` on its rows' first
    `frames` frames, the wave zero past them. A row's own samples, and
    those the denoiser reads to denoise them, equal the whole call's up to
    the arithmetic of another shape. One group at F is the whole call."""
    if len(groups) == 1 and groups[0][1] == mel.shape[1]:
        return chunked_vocode(generator, mel).float()
    wave = None
    for rows, frames in groups:
        index = _rows(rows, mel.device)
        out = chunked_vocode(generator, mel[index, :frames]).float()
        if wave is None:
            hop = out.shape[-1] // frames
            wave = out.new_zeros((mel.shape[0], mel.shape[1] * hop))
        wave[index, : out.shape[-1]] = out
    return wave


def chunked_vocode(generator: Callable[[torch.Tensor], torch.Tensor],
                   mel: torch.Tensor, *, core: int = 480,
                   overlap: int = VOCODE_MARGIN,
                   slab: int = 64, direct_limit: int = 65536) -> torch.Tensor:
    """Memory-bounded vocoding of long or batched mels by overlap-discard.

    mel [B, F, n_mels] -> wave [B, F*hop], equal to vocoding the full mel in
    one call: with `overlap` >= the generator's reach (VOCODE_MARGIN) every
    chunk core reproduces the full call, and windows
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
