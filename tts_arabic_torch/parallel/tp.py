"""Tensor (model) parallelism for FastPitch's FFT stacks (the port's
counterpart of the JAX package's `parallel/tp.py`).

Megatron's column/row pair on every ConvFFN (`models/layers.py::ConvFFN`,
reference `PositionwiseConvFF`): in the reference layout

  CoreNet.0.weight [d_inner, d_model, k] -> split on dim 0 (column)
  CoreNet.0.bias   [d_inner]             -> split on dim 0
  CoreNet.2.weight [d_model, d_inner, k] -> split on dim 1 (row: conv2's
                                            contracting dim)

so each rank computes a full-depth slice of the hidden activation, conv2
gives partial sums of the output, and ONE all-reduce per FFN block adds
them; conv2's bias is added once after it, then dropout, the residual and
LayerNorm. The hidden [B, T, d_inner / n] activation never leaves its
rank. Everything else (attention, embeddings, predictors, norms) is
replicated. Composes with DP on a 2-D (data x model) mesh: batch rows over
`data`, every FFN contraction over `model`.

The TP forward lives here (`TPConvFFN`, put in place of each ConvFFN of a
copy of the model), so `ConvFFN.forward` stays the one-device path.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from ..models.layers import ConvFFN, conv1d_same, dropout, layer_norm
from .mesh import DATA_AXIS, Mesh, _grid, all_gather, all_reduce

MODEL_AXIS = "model"

__all__ = ["MODEL_AXIS", "TPConvFFN", "make_mesh_dp_tp",
           "fastpitch_tp_shardings", "tp_mel_infer_jit"]

# the ConvFFN parameters that are split, and along which dim
_SPLIT = {"pos_ff.CoreNet.0.weight": 0, "pos_ff.CoreNet.0.bias": 0,
          "pos_ff.CoreNet.2.weight": 1}


def make_mesh_dp_tp(n_data: int, n_model: int) -> Mesh:
    """2-D (data x model) mesh: batch rows over `data`, FFN contractions
    over `model`; `model` is the fast axis, so a model group is
    consecutive ranks."""
    return _grid(n_data, n_model, (DATA_AXIS, MODEL_AXIS), "make_mesh_dp_tp")


def fastpitch_tp_shardings(state_dict, mesh: Mesh) -> dict:
    """{state-dict key: the dim it is split along over `model`, or None
    (replicated)} for a FastPitch state dict: each FFT block's ConvFFN
    conv1 weight and bias on dim 0, conv2 weight on dim 1. d_inner need
    not divide the axis size (`torch.tensor_split`'s slices), but even
    splits (1536 % n == 0 for n in 2, 4, 8, 16) waste nothing."""
    mesh.axis_size(MODEL_AXIS)
    return {k: next((d for s, d in _SPLIT.items() if k.endswith(s)), None)
            for k in state_dict}


class TPConvFFN(nn.Module):
    """One rank's part of a ConvFFN: the rank's slice of conv1's output
    channels and of conv2's input channels, conv2's bias whole. `stats`
    (shared by every block of one model) records each collective as
    (name, shape)."""

    def __init__(self, ffn: ConvFFN, mesh: Mesh, stats: list):
        super().__init__()
        if ffn.ffn_ascale is not None or ffn.calib is not None:
            raise ValueError("tensor parallelism covers the float FFN only")
        n, j = mesh.axis_size(MODEL_AXIS), mesh.axis_index(MODEL_AXIS)
        conv1, conv2 = ffn.CoreNet[0], ffn.CoreNet[2]
        w1 = torch.tensor_split(conv1.weight.detach(), n, dim=0)[j]
        b1 = torch.tensor_split(conv1.bias.detach(), n, dim=0)[j]
        w2 = torch.tensor_split(conv2.weight.detach(), n, dim=1)[j]
        k = conv1.weight.shape[-1]
        like = dict(device=w1.device, dtype=w1.dtype)
        self.conv1 = nn.Conv1d(w1.shape[1], w1.shape[0], k, **like)
        self.conv2 = nn.Conv1d(w2.shape[1], w2.shape[0], k, bias=False,
                               **like)
        with torch.no_grad():
            self.conv1.weight.copy_(w1)
            self.conv1.bias.copy_(b1)
            self.conv2.weight.copy_(w2)
        self.bias2 = nn.Parameter(conv2.bias.detach().clone())
        self.layer_norm = ffn.layer_norm
        self.dropout = ffn.dropout
        self.mesh = mesh
        self.stats = stats

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                gen: torch.Generator | None = None) -> torch.Tensor:
        m = None if mask is None else mask[..., None].to(x.dtype)
        y = x if m is None else x * m
        y = torch.relu(conv1d_same(y, self.conv1))   # [B, T, d_inner / n]
        if m is not None:
            y = y * m
        partial = conv1d_same(y, self.conv2)         # [B, T, d_model]
        self.stats.append(("all_reduce", tuple(partial.shape)))
        y = all_reduce(partial, self.mesh, MODEL_AXIS) + self.bias2.to(
            partial.dtype)
        y = dropout(y, self.dropout, gen)
        return layer_norm(x + y, self.layer_norm)


def _shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """A copy of `model` with every ConvFFN replaced by its TPConvFFN;
    `collectives` on the copy lists the collectives of its calls."""
    sharded = copy.deepcopy(model)
    stats = []
    for parent in list(sharded.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, ConvFFN):
                setattr(parent, name, TPConvFFN(child, mesh, stats))
    sharded.collectives = stats
    return sharded


def tp_mel_infer_jit(model: nn.Module, mesh: Mesh, max_frames: int = 256):
    """The full FastPitch mel inference under DP x TP (JAX's
    `tp_mel_infer_jit`; nothing is compiled here). Returns (fn,
    sharded_model): `fn(sharded_model, tokens)` with tokens [B, T] (B a
    multiple of the `data` axis, the same tokens on every rank) runs this
    rank's rows with its FFN slices and returns (mel [B, max_frames,
    n_mel], mel_lens [B]) whole on every rank. The copy holds this rank's
    slices (`fastpitch_tp_shardings`), made once."""
    sharded = _shard_model(model, mesh)
    n_data = mesh.axis_size(DATA_AXIS)

    @torch.no_grad()
    def fn(sharded_model, tokens: torch.Tensor):
        if tokens.shape[0] % n_data:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"mesh[{DATA_AXIS!r}]={n_data}")
        rows = tokens.shape[0] // n_data
        i = mesh.axis_index(DATA_AXIS)
        out = sharded_model.infer(tokens[i * rows: (i + 1) * rows],
                                  max_frames=max_frames)
        mel, lens = out["mel"], out["mel_lens"]
        if n_data > 1:
            stats = sharded_model.collectives
            stats.append(("all_gather", tuple(mel.shape)))
            stats.append(("all_gather", tuple(lens.shape)))
            mel = all_gather(mel, mesh, DATA_AXIS)
            lens = all_gather(lens, mesh, DATA_AXIS)
        return mel, lens

    return fn, sharded
