"""Static-scale int8 1-D convolution (torch counterpart of the JAX
package's `ops/int8.py`), shared by the HiFi-GAN MRF serving path
(`ops/hifigan_int8.py`) and the FastPitch decoder FFN
(`models/layers.py::ConvFFN`).

The input is quantized on a static, pre-calibrated scale and the weights
per output channel, both symmetric on [-127, 127]; the product is an
int8 x int8 -> int32 GEMM, exact for every shape here (|acc| <= k * C *
127^2 < 2^31). The JAX package leaves this conv to XLA, outside any Pallas
kernel; here the GEMM is `torch._int_mm` (cuBLASLt's s8 GEMM on the card)
on the input's k taps unfolded to [B * T, k * C]. The only approximation
is the rounding of inputs and weights to their grids, so the result is the
f32 fake-quant conv to f32 accumulation tolerance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# cuBLASLt's s8 GEMM takes M > 16 rows (and K, N multiples of 8); shorter
# inputs are padded with zero rows to this many
_MIN_ROWS = 32


def weight_qparams(weight: torch.Tensor):
    """Per-output-channel symmetric int8 grid of a Conv1d weight
    [C_out, C_in, k]: (wq [C_out, C_in, k] int8, wscale [C_out] f32), with
    wscale = max(max |w|, 1e-12) / 127 in f32, as the JAX package computes
    it from its [k, C_in, C_out] kernel."""
    wf = weight.float()
    wmax = wf.abs().amax(dim=(1, 2))
    wscale = torch.clamp(wmax, min=1e-12) / 127.0
    wq = torch.clamp(torch.round(wf / wscale[:, None, None]), -127, 127)
    return wq.to(torch.int8), wscale


def gemm_weight(weight: torch.Tensor):
    """(wq as the GEMM's [C_out, k * C_in] int8 matrix, tap-major, then
    input channel; wscale [C_out] f32). Kept on `weight` until it changes
    in place or its data moves, so a caller that passes the same weights
    each call quantizes them once."""
    key = (weight.data_ptr(), weight._version)
    kept = getattr(weight, "_int8_gemm", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    wq, wscale = weight_qparams(weight.detach())
    out = (wq.permute(0, 2, 1).reshape(wq.shape[0], -1).contiguous(), wscale)
    weight._int8_gemm = (key, out)
    return out


def quantize(y: torch.Tensor, ascale) -> torch.Tensor:
    """clip(round(y * (1 / ascale)), -127, 127) as int8, rounding half to
    even. `ascale` is a python float (1 / ascale taken in float64 and
    rounded to f32, as JAX does for a python scalar) or an f32 tensor
    (1 / ascale divided in f32, as JAX does for a traced scale)."""
    inv = 1.0 / ascale
    return torch.clamp(torch.round(y.float() * inv), -127, 127).to(
        torch.int8)


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, kernel_size: int,
                  dilation: int) -> torch.Tensor:
    """The SAME conv's int32 accumulators: xq [B, T, C] int8, wq [C_out,
    k * C] int8 -> [B, T, C_out] int32, through one `torch._int_mm` on
    the taps unfolded to [B * T, k * C]."""
    B, T, C = xq.shape
    k = kernel_size
    pad = (k - 1) * dilation // 2
    xp = F.pad(xq, (0, 0, pad, pad))
    taps = torch.cat([xp[:, j * dilation: j * dilation + T]
                      for j in range(k)], dim=-1).reshape(B * T, k * C)
    rows = B * T
    if xq.device.type == "cuda" and rows < _MIN_ROWS:
        taps = F.pad(taps, (0, 0, 0, _MIN_ROWS - rows))
    acc = torch._int_mm(taps, wq.t())
    return acc[:rows].reshape(B, T, wq.shape[0])


def int8_conv_static(y: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, dilation: int,
                     ascale) -> torch.Tensor:
    """SAME conv with static-scale int8 activations and per-channel int8
    weights: y [B, T, C] (any float dtype), weight [C_out, C, k] (a torch
    Conv1d's) -> [B, T, C_out] in y's dtype. The output is acc * (ascale *
    wscale) + bias in f32."""
    wq, wscale = gemm_weight(weight)
    acc = int8_conv_acc(quantize(y, ascale), wq, weight.shape[-1], dilation)
    out = acc.float() * (ascale * wscale) + bias.float()
    return out.to(y.dtype)
