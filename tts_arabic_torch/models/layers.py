"""Shared neural layers for FastPitch (torch counterparts of the JAX
package's `models/layers.py`).

Layout is feature-last [B, T, C] at every public function, as in the JAX
package; convolutions transpose to torch's [B, C, T] inside. Parameter
names follow the reference PyTorch FastPitch state dict
(`transformer.py`, `model.py`), so its `.pth` files load with
`strict=True`. Every layer casts its weights to the input's dtype, so one
f32 module runs in bf16 when given bf16 inputs (the JAX pipeline casts its
parameters the same way).

Dropout runs only in training, where the caller passes a `torch.Generator`
on the input's device (`gen`); with `gen=None` (inference) every dropout
site is the identity. The sites are the JAX package's: attention
probabilities and output, the FFN output, the embedding, each predictor
layer.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_NEG_INF = -1e9  # large-negative fill; avoids NaN from (-inf * 0) under masks


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask (True inside the sequence)."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def sinusoidal_positions(n_pos: int, dim: int) -> np.ndarray:
    """[n_pos, dim] sinusoidal table, concat(sin, cos) layout (reference
    `PositionalEmbedding`, transformer.py:34-48), computed in float64."""
    inv_freq = 1.0 / (10000 ** (np.arange(0.0, dim, 2.0) / dim))
    angles = np.arange(n_pos)[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(angles), np.cos(angles)],
                          axis=1).astype(np.float32)



def dropout(x: torch.Tensor, rate: float,
            gen: torch.Generator | None) -> torch.Tensor:
    """flax's `nn.Dropout`: keep each value with probability 1 - rate and
    scale it by 1 / (1 - rate). The identity without a generator
    (inference) or at rate 0. The mask is drawn from `gen`, on x's
    device."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), b)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, layer.normalized_shape, layer.weight.to(x.dtype),
                        layer.bias.to(x.dtype), layer.eps)


def conv1d_same(x: torch.Tensor, layer: nn.Conv1d,
                dilation: int = 1) -> torch.Tensor:
    """SAME-padded Conv1d on feature-last x [B, T, C_in] -> [B, T, C_out]
    (odd kernel sizes)."""
    k = layer.weight.shape[-1]
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), layer.weight.to(x.dtype), b,
                 padding=dilation * (k - 1) // 2, dilation=dilation)
    return y.transpose(1, 2)


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self-attention, post-LN residual block
    (reference `MultiHeadAttn`, transformer.py:93-160): plain matmul and
    softmax, as the JAX package computes it."""

    def __init__(self, n_head: int, d_model: int, d_head: int,
                 dropout: float = 0.0, dropatt: float = 0.0):
        super().__init__()
        self.n_head, self.d_head = n_head, d_head
        self.dropout, self.dropatt = dropout, dropatt
        self.qkv_net = nn.Linear(d_model, 3 * n_head * d_head)
        self.o_net = nn.Linear(n_head * d_head, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        B, T, _ = x.shape
        h, d = self.n_head, self.d_head
        q, k, v = linear(x, self.qkv_net).reshape(B, T, 3, h, d).unbind(2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        scores = scores.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
        probs = dropout(torch.softmax(scores, dim=-1), self.dropatt, gen)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, h * d)
        out = dropout(linear(out, self.o_net), self.dropout, gen)
        return layer_norm(x + out, self.layer_norm)


class ConvFFN(nn.Module):
    """Position-wise conv-k FFN, post-LN residual block (reference
    `PositionwiseConvFF`, transformer.py:51-90). With `mask`, every conv
    input is re-masked so padded positions read as zeros, which makes the
    stack's output at real positions independent of bucket padding (the JAX
    package's pad-invariance).

    int8 serving hooks (JAX's "quant" and "calib" collections), both off
    unless a caller opts in (`FFTransformer.set_ffn_int8`,
    `FFTransformer.calibrate_ffn`):
    - `ffn_ascale`, an f32 tensor [2] on the module's device, runs the two
      convs on `ops.int8.int8_conv_static` with those static input scales
      (pad rows still quantize to exact zeros);
    - `calib`, a dict, records `ffn_amax1` / `ffn_amax2`: the max-abs of
      each masked conv input, max-reduced across calls."""

    def __init__(self, d_model: int, d_inner: int, kernel_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        # reference layout: CoreNet = Sequential(Conv1d, ReLU, Conv1d, ...)
        self.CoreNet = nn.Sequential(
            nn.Conv1d(d_model, d_inner, kernel_size), nn.ReLU(),
            nn.Conv1d(d_inner, d_model, kernel_size))
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn_ascale = None
        self.calib = None

    def _record(self, name: str, y: torch.Tensor) -> None:
        amax = y.float().abs().max()
        prev = self.calib.get(name)
        self.calib[name] = amax if prev is None else torch.maximum(prev,
                                                                   amax)

    def _conv(self, y: torch.Tensor, i: int) -> torch.Tensor:
        conv = self.CoreNet[2 * i]
        if self.ffn_ascale is None:
            return conv1d_same(y, conv)
        from ..ops.int8 import int8_conv_static
        return int8_conv_static(y, conv.weight, conv.bias, 1,
                                self.ffn_ascale[i])

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
        m = None if mask is None else mask[..., None].to(x.dtype)
        y = x if m is None else x * m
        if self.calib is not None:
            self._record("ffn_amax1", y)
        y = torch.relu(self._conv(y, 0))
        if m is not None:
            y = y * m
        if self.calib is not None:
            self._record("ffn_amax2", y)
        y = dropout(self._conv(y, 1), self.dropout, gen)
        return layer_norm(x + y, self.layer_norm)


class FFTBlock(nn.Module):
    """One transformer layer: masked self-attention + conv FFN, with the
    reference's mask-multiplies after each sublayer (transformer.py:172-177).
    """

    def __init__(self, n_head: int, d_model: int, d_head: int, d_inner: int,
                 kernel_size: int, dropout: float = 0.0,
                 dropatt: float = 0.0):
        super().__init__()
        self.dec_attn = SelfAttention(n_head, d_model, d_head, dropout,
                                      dropatt)
        self.pos_ff = ConvFFN(d_model, d_inner, kernel_size, dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        x = self.dec_attn(x, mask, gen) * m
        return self.pos_ff(x, mask, gen) * m


class PositionalEmbedding(nn.Module):
    """Holds the reference's `inv_freq` buffer so its checkpoints load
    strictly; the table itself comes from `sinusoidal_positions`."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        inv_freq = 1.0 / (10000.0 ** (np.arange(0.0, d_model, 2.0) / d_model))
        self.register_buffer(
            "inv_freq", torch.from_numpy(inv_freq.astype(np.float32)))
        # (device, dtype) -> tables on that device, the last the longest
        self._tables = {}

    def table(self, n_pos: int, device, dtype) -> torch.Tensor:
        """`sinusoidal_positions(n_pos, d_model)` on the device in `dtype`:
        a view of a table made once per doubling of the length, since a
        copy from pageable host memory first waits for everything queued on
        the device. Shorter tables are kept: a CUDA graph captured on one
        reads its memory. Callers must not write to the view."""
        tables = self._tables.setdefault((torch.device(device), dtype), [])
        if not tables or tables[-1].shape[0] < n_pos:
            n = max(n_pos, 2 * tables[-1].shape[0] if tables else 1024)
            tables.append(torch.from_numpy(
                sinusoidal_positions(n, self.d_model)).to(device, dtype))
        return tables[-1][:n_pos]


class FFTransformer(nn.Module):
    """Stack of FFT blocks with sinusoidal positions; optionally owns the
    token embedding (reference `FFTransformer`, transformer.py:180-225)."""

    def __init__(self, n_layer: int, n_head: int, d_model: int, d_head: int,
                 d_inner: int, kernel_size: int, embed_input: bool = False,
                 n_embed: int | None = None, padding_idx: int = 0,
                 dropout: float = 0.0, dropatt: float = 0.0,
                 dropemb: float = 0.0):
        super().__init__()
        self.padding_idx = padding_idx
        self.dropemb = dropemb
        if embed_input:
            self.word_emb = nn.Embedding(n_embed, d_model)
        self.pos_emb = PositionalEmbedding(d_model)
        self.layers = nn.ModuleList(
            FFTBlock(n_head, d_model, d_head, d_inner, kernel_size, dropout,
                     dropatt)
            for _ in range(n_layer))

    def forward(self, inputs: torch.Tensor, seq_lens=None,
                conditioning=0.0, gen: torch.Generator | None = None):
        """inputs: int tokens [B, T] (with a word embedding) or features
        [B, T, C]. Returns (out [B, T, C], mask [B, T] bool)."""
        if hasattr(self, "word_emb"):
            x = self.embed_tokens(inputs)
            mask = inputs != self.padding_idx
        else:
            x = inputs
            mask = sequence_mask(seq_lens, x.shape[1])
        pos = self.pos_emb.table(x.shape[1], x.device, x.dtype)
        x = x + pos[None] * mask[..., None].to(x.dtype) + conditioning
        x = dropout(x, self.dropemb, gen)
        for block in self.layers:
            x = block(x, mask, gen)
        return x, mask

    def embed_tokens(self, inputs: torch.Tensor) -> torch.Tensor:
        return F.embedding(inputs, self.word_emb.weight)

    def set_ffn_int8(self, scales) -> None:
        """Each layer's ConvFFN on int8 with its static input scales
        (`scales[i]`, two floats or an f32 [2] tensor), or every one back
        to float (`scales=None`)."""
        if scales is not None and len(scales) != len(self.layers):
            raise ValueError(f"{len(scales)} FFN scales for "
                             f"{len(self.layers)} layers")
        for i, layer in enumerate(self.layers):
            ff = layer.pos_ff
            ff.ffn_ascale = None if scales is None else torch.as_tensor(
                scales[i], dtype=torch.float32,
                device=ff.CoreNet[0].weight.device)

    @contextlib.contextmanager
    def calibrate_ffn(self):
        """Within, every ConvFFN records its inputs' max-abs; yields one
        dict per layer ({"ffn_amax1", "ffn_amax2"} f32 device scalars once
        a forward ran)."""
        stats = [{} for _ in self.layers]
        for layer, d in zip(self.layers, stats):
            layer.pos_ff.calib = d
        try:
            yield stats
        finally:
            for layer in self.layers:
                layer.pos_ff.calib = None


class ConvReLUNorm(nn.Module):
    """Conv -> ReLU -> LayerNorm (reference `ConvReLUNorm`, model.py:45-57).
    `mask` re-masks the conv input for pad-invariance."""

    def __init__(self, in_channels: int, channels: int,
                 kernel_size: int = 3, dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, channels, kernel_size)
        self.norm = nn.LayerNorm(channels, eps=1e-5)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        y = layer_norm(torch.relu(conv1d_same(x, self.conv)), self.norm)
        return dropout(y, self.dropout, gen)


class TemporalPredictor(nn.Module):
    """Per-position scalar predictor head (reference `TemporalPredictor`,
    model.py:114-133)."""

    def __init__(self, in_channels: int, filter_size: int,
                 kernel_size: int = 3, n_layers: int = 2,
                 n_predictions: int = 1, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            ConvReLUNorm(in_channels if i == 0 else filter_size, filter_size,
                         kernel_size, dropout)
            for i in range(n_layers))
        self.fc = nn.Linear(filter_size, n_predictions)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        m = mask[..., None].to(x.dtype)
        y = x * m
        for layer in self.layers:
            y = layer(y, mask, gen)
        return linear(y, self.fc) * m


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random init in the JAX package's scheme (flax defaults):
    Linear/Conv weights normal with std 1/sqrt(fan_in), embeddings std
    1/sqrt(dim), transposed convs std 0.01, biases zero, LayerNorm scale
    one. Drawn on the CPU from a `torch.Generator`, so the result does not
    depend on the device. The numbers differ from flax's for the same
    seed; tests that compare the two carry weights across with
    `models.convert`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                continue
            if isinstance(mod, nn.Embedding):
                std = mod.weight.shape[1] ** -0.5
            elif isinstance(mod, nn.ConvTranspose1d):
                std = 0.01
            elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                std = mod.weight[0].numel() ** -0.5
            else:
                continue
            w = torch.randn(mod.weight.shape, generator=gen) * std
            mod.weight.copy_(w)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
    return module
