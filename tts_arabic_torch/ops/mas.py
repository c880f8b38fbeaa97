"""Monotonic alignment search as a hand-written CUDA kernel, with its plain
version.

Replaces `tts_arabic_tpu/ops/mas_pallas.py::mas_pallas` (`_opt_kernel`).
Source: `csrc/mas.cu`, one block per batch row: a producer warp streams the
log-attention rows into a shared-memory ring, consumer warps run the DP
with the direction bits packed by ballot into shared memory (or, for a
long row, a global scratch tensor), one warp backtracks, and the block
writes its whole output once. Its note gives the design and what bounds it
(the out_len-long dependent chain, not the bytes). The plain version is
`align.mas.mas`, which computes the same function with the same f32
arithmetic, so the two agree bit for bit.

`mas_fused` takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises; nothing falls back. `LAUNCHES`
counts kernel launches, so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import torch

from ..align.mas import mas as mas_plain

# kernel launches (plain-version calls are not counted)
LAUNCHES = {"mas": 0}

MAX_TEXT_LEN = 12288  # csrc/mas.cu kMaxTxt: the ring's shared memory


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _check(log_attn, in_lens, out_lens):
    if log_attn.dim() != 3 or not log_attn.is_contiguous():
        raise ValueError(f"log_attn must be a contiguous [B, T_mel, T_txt] "
                         f"tensor, got {tuple(log_attn.shape)} contiguous="
                         f"{log_attn.is_contiguous()}")
    if log_attn.dtype != torch.float32:
        raise TypeError(f"mas takes float32 log-attention, not "
                        f"{log_attn.dtype}")
    B = log_attn.shape[0]
    for name, n in (("in_lens", in_lens), ("out_lens", out_lens)):
        if tuple(n.shape) != (B,) or n.dtype.is_floating_point:
            raise ValueError(f"{name} must be an integer [{B}] tensor, got "
                             f"{n.dtype} {tuple(n.shape)}")


def mas_fused(log_attn: torch.Tensor, in_lens: torch.Tensor,
              out_lens: torch.Tensor) -> torch.Tensor:
    """MAS, [B, T_mel, T_txt] f32 log-attention -> one-hot path of the same
    shape (same contract as `align.mas.mas`). CUDA tensors run the kernel
    (T_txt <= MAX_TEXT_LEN); CPU tensors the plain version."""
    _check(log_attn, in_lens, out_lens)
    if log_attn.device.type == "cpu":
        return mas_plain(log_attn, in_lens, out_lens)
    if log_attn.device.type != "cuda":
        raise ValueError(f"mas runs on cuda or cpu, not {log_attn.device}")
    B, T_mel, T_txt = log_attn.shape
    if T_txt > MAX_TEXT_LEN:
        raise ValueError(f"the MAS kernel takes T_txt <= {MAX_TEXT_LEN} "
                         f"(its row ring's shared memory), got {T_txt}")
    from .build import library
    lib = library()
    dev = log_attn.device
    with torch.cuda.device(dev):
        if B == 0 or T_mel == 0 or T_txt == 0:
            return torch.zeros_like(log_attn)
        out = torch.empty_like(log_attn)    # the kernel writes all of it
        ins = in_lens.to(device=dev, dtype=torch.int32).contiguous()
        outs = out_lens.to(device=dev, dtype=torch.int32).contiguous()
        words = lib.mas_scratch_words(T_mel, T_txt)
        # direction bits that do not fit in shared memory
        bits = (torch.empty((B, words), dtype=torch.int32, device=dev)
                if words > 0 else None)
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mas_forward(log_attn.data_ptr(), ins.data_ptr(),
                              outs.data_ptr(), out.data_ptr(),
                              None if bits is None else bits.data_ptr(),
                              B, T_mel, T_txt, stream)
        if err != 0:
            raise RuntimeError(f"mas kernel launch failed: cudaError {err}")
        LAUNCHES["mas"] += 1
        return out
