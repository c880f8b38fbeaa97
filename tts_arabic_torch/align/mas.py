"""Monotonic alignment search (MAS), plain PyTorch (counterpart of the JAX
package's `align/mas.py`).

Width-1 Viterbi over a log-attention map: a forward pass over mel frames,
each step a vectorised max over (stay, advance) across the batch and the
text axis, then a backtrack from each row's (out_len-1, in_len-1) corner
that moves diagonally on ties (`diag >= stay`). Masked text columns are
filled with -inf.

`mas` is the plain version of the CUDA kernel in `ops/mas.py`
(`csrc/mas.cu`); `mas_durations` runs MAS through that wrapper, so a CUDA
tensor goes through the kernel and a CPU tensor through `mas`.
"""
from __future__ import annotations

import torch

_NEG = float("-inf")


def mas(log_attn: torch.Tensor, in_lens: torch.Tensor,
        out_lens: torch.Tensor) -> torch.Tensor:
    """Batched width-1 monotonic alignment search.

    log_attn: [B, T_mel, T_txt] f32; in_lens, out_lens: [B] integer, with
    1 <= in_len <= T_txt and 1 <= out_len. Returns the hard alignment
    [B, T_mel, T_txt] in {0, 1} (log_attn's dtype), zero outside each row's
    valid (out_len, in_len) region. A row whose in_len lies outside
    [1, T_txt] or whose out_len < 1 comes back all zero."""
    B, T_mel, T_txt = log_attn.shape
    dev = log_attn.device
    in_lens = in_lens.to(device=dev, dtype=torch.long)
    out_lens = out_lens.to(device=dev, dtype=torch.long)
    cols = torch.arange(T_txt, device=dev)[None, :]
    attn = torch.where((cols < in_lens[:, None])[:, None, :], log_attn,
                       _NEG)

    # forward DP: row_t = attn_t + max(prev, prev shifted right by one)
    log_p = torch.empty_like(attn)
    prev = torch.where(cols == 0, attn[:, 0, :], _NEG)
    log_p[:, 0] = prev
    neg = torch.full((B, 1), _NEG, dtype=attn.dtype, device=dev)
    for t in range(1, T_mel):
        shifted = torch.cat([neg, prev[:, :-1]], dim=1)
        prev = attn[:, t] + torch.maximum(prev, shifted)
        log_p[:, t] = prev

    # backtrack from (out_len-1, in_len-1); rows >= out_len stay empty
    valid = (in_lens >= 1) & (in_lens <= T_txt) & (out_lens >= 1)
    rows = torch.arange(B, device=dev)
    j = torch.clamp(in_lens - 1, 0, T_txt - 1)
    opt = torch.zeros_like(attn)
    for i in range(T_mel - 1, 0, -1):
        active = (i < out_lens) & valid
        opt[rows, i, j] = active.to(opt.dtype)
        prev_row = log_p[:, i - 1]
        stay = prev_row[rows, j]
        diag = prev_row[rows, torch.clamp(j - 1, min=0)]
        move = active & (j > 0) & (diag >= stay)
        j = torch.where(move, j - 1, j)
    opt[rows, 0, j] = valid.to(opt.dtype)
    return opt


def mas_durations(attn_soft: torch.Tensor, in_lens: torch.Tensor,
                  out_lens: torch.Tensor):
    """Soft attention [B, T_mel, T_txt] -> (hard alignment, durations
    [B, T_txt]): MAS on log(max(attn, 1e-12)) with no gradient, through
    the kernel wrapper `ops.mas.mas_fused`."""
    from ..ops import mas as mas_ops
    with torch.no_grad():
        log_attn = torch.log(torch.clamp(attn_soft.detach(), min=1e-12))
        hard = mas_ops.mas_fused(log_attn.contiguous(), in_lens, out_lens)
    return hard, hard.sum(dim=1)
