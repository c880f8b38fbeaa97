"""HiFi-GAN ResBlock1 as a hand-written CUDA kernel, with its plain version.

Replaces `tts_arabic_tpu/ops/hifigan_pallas.py::resblock_pallas` (the wide
variant here, C >= 64: one fused [leaky -> dilated conv -> leaky -> conv ->
add] pass per launch, three launches per ResBlock) and `::
resblock_pallas_packed` (the narrow variant, C <= 32: the whole ResBlock in
one launch). Source: `csrc/resblock1.cu`, whose note gives the designs, the
shared-memory budgets and what bounds each. Both dtypes run implicit-GEMM
convs on the tensor cores (`mma.sync`, weights streamed through shared
memory by `cp.async`): bf16 in bf16, f32 in 3xTF32 (each operand split into
two TF32 parts, three products a term, f32 accumulation; `tf32_split`
gives the split on either device).

`resblock1` takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises; nothing falls back. `LAUNCHES`
counts kernel launches per variant, so a run can show that its path went
through the kernel.

While a gradient is recorded, `resblock1` runs through `ResBlock1Function`:
the forward as without one (the kernel on the card), and a backward that
recomputes the block with `resblock1_plain` and differentiates that, an
activation checkpoint. The JAX package has no backward kernel either: its
training differentiates the flax `ResBlock1` with XLA's autodiff.

The kernel is also the custom op `tts_arabic::resblock1` (`resblock1_op`),
which takes its weights already in the kernel layout (`kernel_weights`). A
tracer sees the op, not the ctypes launch behind it, so a program exported
with `torch.export` calls the kernel (`apps.export_serving`), with the
kernel-layout weights made once, at export, as constants of the program.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1

# kernel launches per variant (plain-version calls are not counted)
LAUNCHES = {"resblock1_wide": 0, "resblock1_narrow": 0}

# widths each kernel is built for (their tiles are fixed in the source); K
# runs in steps of 16 channels in bf16, of 8 in f32
_WIDTHS = {
    (torch.float32, "resblock1_wide"): (256, 128, 64),
    (torch.float32, "resblock1_narrow"): (64, 32, 16, 8),
    (torch.bfloat16, "resblock1_wide"): (256, 128, 64),
    (torch.bfloat16, "resblock1_narrow"): (64, 32, 16),
}
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
    [k*C_in, C_out] matrix, K rows (tap, then input channel) by N.

    The result is kept on `w` until `w` changes in place or is asked for
    in another dtype, so a caller that passes the same weights each call
    (`vocoder.hifigan.ResBlock1`) converts them once. A `w` that records
    gradients (a training step's fresh stack) is converted afresh and
    nothing is kept on it."""
    if w.requires_grad:
        return w.permute(0, 3, 2, 1).contiguous().to(dtype)
    key = (w._version, dtype)
    kept = getattr(w, "_kernel_layout", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    out = w.permute(0, 3, 2, 1).contiguous().to(dtype)
    w._kernel_layout = (key, out)
    return out


def _check(x, w1, b1, w2, b2, k, dilations, kernel_layout=False):
    """Raise on inputs the kernels do not take. w1, w2 in the Conv1d
    layout [n_d, C_out, C_in, k], or with `kernel_layout` in the kernels'
    own [n_d, k, C_in, C_out]."""
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
    want = (n, k, C, C) if kernel_layout else (n, C, C, k)
    layout = "the kernel layout" if kernel_layout else "the Conv1d layout"
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != want:
            raise ValueError(f"{name} must be {list(want)} ({layout}), got "
                             f"{tuple(w.shape)}")
        if kernel_layout and (w.dtype != x.dtype or not w.is_contiguous()):
            raise ValueError(f"{name} must be contiguous in {x.dtype}, the "
                             "kernel layout of kernel_weights()")
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
    version. While a gradient is recorded for any input, the call goes
    through `ResBlock1Function`, so the result is never cut off from the
    graph."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return ResBlock1Function.apply(x, w1, b1, w2, b2, kernel_size,
                                       tuple(dilations))
    return _forward(x, w1, b1, w2, b2, kernel_size, dilations)


class ResBlock1Function(torch.autograd.Function):
    """`resblock1` with a gradient. Forward: the kernel on a CUDA tensor,
    the plain version on a CPU one, under no_grad; it keeps x and the four
    stacked weights and no intermediate. Backward: the block recomputed
    with `resblock1_plain` on detached leaves and differentiated (an
    activation checkpoint), so the kernel's forward is what runs and the
    recompute is plain."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, kernel_size, dilations):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.kernel_size, ctx.dilations = kernel_size, tuple(dilations)
        return _forward(x, w1, b1, w2, b2, kernel_size, dilations)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[:5]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y = resblock1_plain(*leaves, ctx.kernel_size, ctx.dilations)
        got = iter(torch.autograd.grad(
            y, [t for t, n in zip(leaves, need) if n], grad))
        return (*(next(got) if n else None for n in need), None, None)


def _forward(x, w1, b1, w2, b2, kernel_size, dilations) -> torch.Tensor:
    """The forward without a graph: the kernel on the card, the plain
    version on the CPU."""
    _check(x, w1, b1, w2, b2, kernel_size, dilations)
    if x.device.type == "cpu":
        with torch.no_grad():
            return resblock1_plain(x, w1, b1, w2, b2, kernel_size,
                                   dilations)
    return _launch(x, kernel_weights(w1, x.dtype), b1,
                   kernel_weights(w2, x.dtype), b2, kernel_size, dilations)


@torch.library.custom_op("tts_arabic::resblock1", mutates_args=())
def resblock1_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, kernel_size: int,
                 dilations: list[int]) -> torch.Tensor:
    """ResBlock1 forward as a custom op, x [B, T, C] -> [B, T, C], its
    convs' weights w1, w2 in the kernel layout [n_d, k, C_in, C_out] in
    x's dtype (`kernel_weights`), biases b1, b2 [n_d, C]. A CUDA tensor
    runs the kernel (the same launch as `resblock1`, counted in
    LAUNCHES); a CPU tensor the plain version."""
    _check(x, w1, b1, w2, b2, kernel_size, dilations, kernel_layout=True)
    if x.device.type == "cpu":
        return resblock1_plain(x, w1.permute(0, 3, 2, 1), b1,
                               w2.permute(0, 3, 2, 1), b2, kernel_size,
                               dilations)
    return _launch(x, w1, b1, w2, b2, kernel_size, dilations)


@resblock1_op.register_fake
def _(x, w1, b1, w2, b2, kernel_size, dilations):
    _check(x, w1, b1, w2, b2, kernel_size, dilations, kernel_layout=True)
    return torch.empty_like(x)


def _launch(x, w1k, b1, w2k, b2, kernel_size, dilations) -> torch.Tensor:
    """The kernel's launches on a CUDA tensor, weights in the kernel
    layout: one for the narrow variant, one per dilation for the wide."""
    if x.device.type != "cuda":
        raise ValueError(f"resblock1 runs on cuda or cpu, not {x.device}")
    from .build import library
    lib = library()
    B, T, C = x.shape
    k = kernel_size
    name = variant(C)
    narrow = name == "resblock1_narrow"
    if C not in _WIDTHS[x.dtype, name] or (narrow and len(dilations) > 3):
        raise ValueError(f"no {name} kernel for C={C}, "
                         f"{len(dilations)} dilations in {x.dtype}")
    if x.data_ptr() % 16:               # the kernels read x 16 bytes at once
        raise ValueError("x must start on a 16-byte boundary")
    suffix = "bf16" if x.dtype == torch.bfloat16 else "f32"
    b1k = b1.contiguous().to(torch.float32)
    b2k = b2.contiguous().to(torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(x)
        if narrow:
            d = list(dilations) + [1] * (3 - len(dilations))
            err = getattr(lib, f"resblock1_fused_{suffix}")(
                x.data_ptr(), out.data_ptr(), w1k.data_ptr(), b1k.data_ptr(),
                w2k.data_ptr(), b2k.data_ptr(), B, T, C, k, len(dilations),
                d[0], d[1], d[2], stream)
            _raise_on(err, name)
            LAUNCHES[name] += 1
            return out
        # one launch per pass, ping-ponging between two buffers; the last
        # pass lands in `out`
        launch = getattr(lib, f"resblock1_pass_{suffix}")
        bufs = [out, torch.empty_like(x)]
        src = x
        for i, d in enumerate(dilations):
            dst = bufs[(len(dilations) - 1 - i) % 2]
            err = launch(src.data_ptr(), dst.data_ptr(), w1k[i].data_ptr(),
                         b1k[i].data_ptr(), w2k[i].data_ptr(),
                         b2k[i].data_ptr(), B, T, C, k, d, stream)
            _raise_on(err, name)
            LAUNCHES[name] += 1
            src = dst
        return out


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 bits: rounded to 10 mantissa bits, to
    nearest with ties away from zero (half of the dropped 13 bits' unit
    added to the magnitude, a carry running into the exponent), the low 13
    bits zero; infinities stay, NaN stays NaN."""
    bits = v.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), out, v)


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The split the f32 kernels make of each operand, v ~ big + small with
    big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v - big), both f32
    tensors of TF32 values. A CPU tensor gets the plain version; a CUDA
    tensor the kernels' own split, run elementwise (a probe for the tests,
    on no model's path and not counted in LAUNCHES)."""
    if v.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, not {v.dtype}")
    v = v.contiguous()
    if v.device.type == "cpu":
        big = _tf32_rna(v)
        return big, _tf32_rna(v - big)
    if v.device.type != "cuda":
        raise ValueError(f"tf32_split runs on cuda or cpu, not {v.device}")
    from .build import library
    big, small = torch.empty_like(v), torch.empty_like(v)
    if v.numel():
        with torch.cuda.device(v.device):
            err = library().resblock1_tf32_split(
                v.data_ptr(), big.data_ptr(), small.data_ptr(), v.numel(),
                torch.cuda.current_stream().cuda_stream)
        _raise_on(err, "resblock1_tf32_split")
    return big, small
