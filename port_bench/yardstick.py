"""The benchmark's own arithmetic, frozen here so that no later change to
the program moves the yardstick: the card's published peaks, the least
time of a ResBlock1 (a copy of `chip_smoke.py`'s `bound()`), and the
analytic FLOP counts of the models (a copy of the port's
`eval/flops.py` and `vocoder/hifigan.py::generator_flops_per_frame`,
on the published config dicts). `tests/test_port_bench_arith.py` holds
each copy equal to the program's function.

FLOPs count a multiply-add as 2, matmul and conv terms only.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its full 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
PEAK_BYTES = 3.35e12
# the f32 ResBlock kernels run 3xTF32: three TF32 products a term
RESBLOCK_F32_FLOPS = 495e12 / 3
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def resblock_bound(C: int, k: int, T: int, dtype: str,
                   batch: int) -> tuple[float, float]:
    """Least times (ms) for one ResBlock1 (three dilated passes) on
    [batch, T, C]: 6 convs of 2 k C^2 FLOPs a row at the kernels' rate for
    the dtype, and x read once, y written once and the weights read once
    at the memory rate. -> (operations ms, bytes ms)."""
    esize = ELEMENT_BYTES[dtype]
    flops = 12 * k * C * C * batch * T
    nbytes = 2 * batch * T * C * esize + 6 * k * C * C * esize + 6 * C * 4
    peak = RESBLOCK_F32_FLOPS if dtype == "float32" else PEAK_FLOPS[dtype]
    return flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3


def generator_resblock_bound_s(h: dict, mel_shape: tuple,
                               dtype: str) -> float:
    """The least time (s) of every MRF ResBlock of one generator call on a
    mel [B, frames, n_mel]: each block's bound, the larger of its two."""
    B, frames = mel_shape[0], mel_shape[1]
    total, t = 0.0, frames
    for i, u in enumerate(h["upsample_rates"]):
        C = h["upsample_initial_channel"] // 2 ** (i + 1)
        t *= u
        for k in h["resblock_kernel_sizes"]:
            total += max(resblock_bound(C, k, t, dtype, B))
    return total * 1e-3


def generator_flops_per_frame(h: dict) -> int:
    total = 7 * h["num_mels"] * h["upsample_initial_channel"]
    t_mult = 1
    ch_in = h["upsample_initial_channel"]
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        ch = h["upsample_initial_channel"] // (2 ** (i + 1))
        t_mult *= u
        total += t_mult * k * ch_in * ch // u
        for rk, rd in zip(h["resblock_kernel_sizes"],
                          h["resblock_dilation_sizes"]):
            total += t_mult * 2 * len(rd) * rk * ch * ch
        ch_in = ch
    total += t_mult * 7 * ch_in
    return 2 * total


def fft_stack_flops(T: int, n_layers: int, d_model: int, n_heads: int,
                    d_head: int, filter_size: int, kernel_size: int) -> int:
    attn = (2 * T * d_model * 3 * n_heads * d_head
            + 2 * T * T * n_heads * d_head
            + 2 * T * T * n_heads * d_head
            + 2 * T * n_heads * d_head * d_model)
    ffn = (2 * T * kernel_size * d_model * filter_size
           + 2 * T * kernel_size * filter_size * d_model)
    return n_layers * (attn + ffn)


def _predictor_flops(T: int, d_model: int, filter_size: int,
                     n_layers: int, kernel_size: int) -> int:
    f = 2 * T * kernel_size * d_model * filter_size
    f += (n_layers - 1) * 2 * T * kernel_size * filter_size * filter_size
    return f + 2 * T * filter_size


def fastpitch_encode_flops(net: dict, n_tokens: int) -> int:
    T, d = n_tokens, net["symbols_embedding_dim"]
    f = fft_stack_flops(T, net["in_fft_n_layers"], d, net["in_fft_n_heads"],
                        net["in_fft_d_head"],
                        net["in_fft_conv1d_filter_size"],
                        net["in_fft_conv1d_kernel_size"])
    for p in ("dur", "pitch"):
        f += _predictor_flops(T, d, net[f"{p}_predictor_filter_size"],
                              net[f"{p}_predictor_n_layers"],
                              net[f"{p}_predictor_kernel_size"])
    f += 2 * T * net["pitch_embedding_kernel_size"] * 1 * d
    if net["energy_conditioning"]:
        f += _predictor_flops(T, d, net["energy_predictor_filter_size"],
                              net["energy_predictor_n_layers"],
                              net["energy_predictor_kernel_size"])
        f += 2 * T * net["energy_embedding_kernel_size"] * d
    return f


def fastpitch_decode_flops(net: dict, n_tokens: int, n_frames: int) -> int:
    F, d = n_frames, net["symbols_embedding_dim"]
    f = 2 * F * n_tokens * d
    f += fft_stack_flops(F, net["out_fft_n_layers"], d,
                         net["out_fft_n_heads"], net["out_fft_d_head"],
                         net["out_fft_conv1d_filter_size"],
                         net["out_fft_conv1d_kernel_size"])
    return f + 2 * F * d * net["n_mel_channels"]
