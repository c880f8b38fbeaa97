"""HiFi-GAN ResBlock1 as a hand-written CUDA kernel, with its plain version.

Replaces `tts_arabic_tpu/ops/hifigan_pallas.py::resblock_pallas` (the wide
variant here, C >= 64: one fused [leaky -> dilated conv -> leaky -> conv ->
add] pass per launch, three launches per ResBlock) and `::
resblock_pallas_packed` (the narrow variant, C <= 32: the whole ResBlock in
one launch). Source: `csrc/resblock1.cu`, whose note gives the designs, the
shared-memory budgets and what bounds each. bf16 runs implicit-GEMM convs on
the tensor cores (`mma.sync`, weights streamed through shared memory by
`cp.async`); f32 runs the first design on the f32 CUDA cores.

`resblock1` takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises; nothing falls back. `LAUNCHES`
counts kernel launches per variant, so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1

# kernel launches per variant (plain-version calls are not counted)
LAUNCHES = {"resblock1_wide": 0, "resblock1_narrow": 0}

# f32 kernels: time rows per block, the most each variant's shared memory
# allows at k=11 with a few blocks per SM (see csrc/resblock1.cu)
_WIDE_TILE = {256: 32, 128: 64, 64: 64}
_NARROW_TILE = {64: 64, 32: 128, 16: 128, 8: 128}
# widths the bf16 kernels are built for (their tiles are fixed in the source)
_WIDTHS_BF16 = {"resblock1_wide": (256, 128, 64),
                "resblock1_narrow": (64, 32, 16)}
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def resblock1_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, kernel_size: int,
                    dilations: Sequence[int]) -> torch.Tensor:
    """ResBlock1 in plain PyTorch: x [B, T, C] -> [B, T, C] in x's dtype.

    w1, w2: [n_d, C_out, C_in, k] torch Conv1d weights of the dilated and
    the plain convs; b1, b2: [n_d, C]."""
    k = kernel_size
    h = x.transpose(1, 2)
    for i, d in enumerate(dilations):
        y = F.leaky_relu(h, LRELU_SLOPE)
        y = F.conv1d(y, w1[i].to(x.dtype), b1[i].to(x.dtype), dilation=d,
                     padding=d * (k - 1) // 2)
        y = F.leaky_relu(y, LRELU_SLOPE)
        y = F.conv1d(y, w2[i].to(x.dtype), b2[i].to(x.dtype),
                     padding=(k - 1) // 2)
        h = h + y
    return h.transpose(1, 2).contiguous()


def variant(channels: int) -> str:
    """The kernel variant that serves a ResBlock of this width."""
    return "resblock1_narrow" if channels <= 32 else "resblock1_wide"


def kernel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Stacked Conv1d weights [n_d, C_out, C_in, k] -> the layout the
    kernels read, [n_d, k, C_in, C_out] contiguous in `dtype`: each conv a
    [k*C_in, C_out] matrix, K rows (tap, then input channel) by N."""
    return w.permute(0, 3, 2, 1).contiguous().to(dtype)


def _check(x, w1, b1, w2, b2, k, dilations):
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, C] tensor, got "
                         f"{tuple(x.shape)} contiguous={x.is_contiguous()}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"resblock1 takes float32 or bfloat16, not {x.dtype}")
    B, T, C = x.shape
    n = len(dilations)
    if k % 2 != 1 or n < 1:
        raise ValueError(f"odd kernel size and >= 1 dilation needed, got "
                         f"k={k}, dilations={tuple(dilations)}")
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (n, C, C, k):
            raise ValueError(f"{name} must be [{n}, {C}, {C}, {k}], got "
                             f"{tuple(w.shape)}")
    for name, b in (("b1", b1), ("b2", b2)):
        if tuple(b.shape) != (n, C):
            raise ValueError(f"{name} must be [{n}, {C}], got "
                             f"{tuple(b.shape)}")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError(f"weights on {t.device}, x on {x.device}")


def resblock1(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, kernel_size: int,
              dilations: Sequence[int]) -> torch.Tensor:
    """ResBlock1 forward, x [B, T, C] -> [B, T, C] (same arguments as
    `resblock1_plain`). CUDA tensors run the kernel; CPU tensors the plain
    version."""
    _check(x, w1, b1, w2, b2, kernel_size, dilations)
    if x.device.type == "cpu":
        return resblock1_plain(x, w1, b1, w2, b2, kernel_size, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"resblock1 runs on cuda or cpu, not {x.device}")
    from .build import library
    lib = library()
    B, T, C = x.shape
    k = kernel_size
    name = variant(C)
    narrow = name == "resblock1_narrow"
    bf16 = x.dtype == torch.bfloat16
    widths = (_WIDTHS_BF16[name] if bf16
              else _NARROW_TILE if narrow else _WIDE_TILE)
    if C not in widths or (narrow and len(dilations) > 3):
        raise ValueError(f"no {name} kernel for C={C}, "
                         f"{len(dilations)} dilations in {x.dtype}")
    if bf16 and x.data_ptr() % 16:     # the kernel reads x 16 bytes at once
        raise ValueError("bf16 x must start on a 16-byte boundary")
    w1k, w2k = kernel_weights(w1, x.dtype), kernel_weights(w2, x.dtype)
    b1k = b1.contiguous().to(torch.float32)
    b2k = b2.contiguous().to(torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(x)
        if narrow:
            d = list(dilations) + [1] * (3 - len(dilations))
            args = (x.data_ptr(), out.data_ptr(), w1k.data_ptr(),
                    b1k.data_ptr(), w2k.data_ptr(), b2k.data_ptr(), B, T, C,
                    k, len(dilations), d[0], d[1], d[2])
            err = (lib.resblock1_fused_bf16(*args, stream) if bf16 else
                   lib.resblock1_fused_f32(*args, _NARROW_TILE[C], stream))
            _raise_on(err, name)
            LAUNCHES[name] += 1
            return out
        # one launch per pass, ping-ponging between two buffers; the last
        # pass lands in `out`
        bufs = [out, torch.empty_like(x)]
        src = x
        for i, d in enumerate(dilations):
            dst = bufs[(len(dilations) - 1 - i) % 2]
            args = (src.data_ptr(), dst.data_ptr(), w1k[i].data_ptr(),
                    b1k[i].data_ptr(), w2k[i].data_ptr(), b2k[i].data_ptr(),
                    B, T, C, k, d)
            err = (lib.resblock1_pass_bf16(*args, stream) if bf16 else
                   lib.resblock1_pass_f32(*args, _WIDE_TILE[C], stream))
            _raise_on(err, name)
            LAUNCHES[name] += 1
            src = dst
        return out


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
