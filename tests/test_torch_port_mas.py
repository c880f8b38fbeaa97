"""Monotonic alignment search: the port's plain MAS (the CUDA kernel's plain
version) against the JAX package's `align.mas` (the function its train step
runs), exactly, and against the Pallas kernel in interpret mode where the
two JAX versions agree (every row has a monotonic path). Inputs are made
with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.align.mas import mas as port_mas
from tts_arabic_torch.align.mas import mas_durations as port_mas_durations
from tts_arabic_torch.ops import mas as mas_ops
from tts_arabic_tpu.align.mas import mas as jax_mas
from tts_arabic_tpu.align.mas import mas_durations as jax_mas_durations
from tts_arabic_tpu.ops.mas_pallas import mas_pallas


def _case(seed, B, T_mel, T_txt, feasible=True):
    """Log-attention with random lengths in [1, T]; one row at full size.
    Unless `feasible`, the last row gets out_len < in_len (no monotonic
    path: the -inf region decides the backtrack)."""
    rng = np.random.default_rng(seed)
    logits = 3.0 * rng.standard_normal((B, T_mel, T_txt))
    attn = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(
        np.float32)
    in_lens = rng.integers(1, T_txt + 1, B)
    out_lens = (rng.integers(in_lens, T_mel + 1) if feasible
                else rng.integers(1, T_mel + 1, B))
    in_lens[0], out_lens[0] = T_txt, T_mel
    if not feasible and B > 1 and T_txt > 1 and T_mel > 1:
        in_lens[-1] = T_txt
        out_lens[-1] = max(1, min(T_mel, T_txt) - 1)
    return attn, in_lens.astype(np.int32), out_lens.astype(np.int32)


def _jax(fn, attn, in_lens, out_lens, **kw):
    return np.asarray(fn(jnp.asarray(attn), jnp.asarray(in_lens),
                         jnp.asarray(out_lens), **kw))


def _port(fn, attn, in_lens, out_lens):
    return fn(torch.from_numpy(attn), torch.from_numpy(in_lens),
              torch.from_numpy(out_lens))


@pytest.mark.parametrize("seed,B,T_mel,T_txt,feasible", [
    (0, 4, 96, 24, True),
    (1, 3, 50, 7, False),       # rows with out_len < in_len
    (2, 5, 40, 33, False),
    (3, 3, 64, 1, True),        # T_txt = 1
    (4, 3, 1, 9, False),        # T_mel = 1
    (5, 2, 1, 1, True),
    (6, 6, 300, 57, True),
    # T_txt past one warp's 1024 columns (the kernel's first design took no
    # more); the last row of each has out_len < in_len
    (7, 2, 24, 1100, False),
    (8, 1, 6, 2100, False),
])
def test_plain_mas_equals_jax_mas(seed, B, T_mel, T_txt, feasible):
    attn, in_lens, out_lens = _case(seed, B, T_mel, T_txt, feasible)
    ref = _jax(jax_mas, attn, in_lens, out_lens)
    got = _port(port_mas, attn, in_lens, out_lens)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # one 1 per valid frame, none past each row's lengths
    np.testing.assert_array_equal(got.numpy().sum((1, 2)), out_lens)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_mas_equals_pallas_interpret(seed):
    attn, in_lens, out_lens = _case(seed, 4, 96, 24, feasible=True)
    ref = _jax(mas_pallas, attn, in_lens, out_lens, interpret=True)
    got = _port(port_mas, attn, in_lens, out_lens)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mas_durations_equal_jax():
    rng = np.random.default_rng(7)
    soft = rng.random((3, 80, 20)).astype(np.float32)
    soft[1, :, 5] = 0.0         # exercises the 1e-12 clip
    soft /= soft.sum(-1, keepdims=True)
    in_lens = np.array([20, 12, 6], np.int32)
    out_lens = np.array([80, 61, 30], np.int32)
    ref_hard, ref_dur = (np.asarray(a) for a in jax_mas_durations(
        jnp.asarray(soft), jnp.asarray(in_lens), jnp.asarray(out_lens)))
    soft_t = torch.from_numpy(soft).requires_grad_()
    hard, dur = port_mas_durations(soft_t, torch.from_numpy(in_lens),
                                   torch.from_numpy(out_lens))
    assert not hard.requires_grad and not dur.requires_grad
    np.testing.assert_array_equal(hard.numpy(), ref_hard)
    np.testing.assert_array_equal(dur.numpy(), ref_dur)
    np.testing.assert_array_equal(dur.numpy().sum(1), out_lens)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    attn, in_lens, out_lens = _case(8, 3, 40, 10, feasible=False)
    before = mas_ops.LAUNCHES["mas"]
    got = _port(mas_ops.mas_fused, attn, in_lens, out_lens)
    assert mas_ops.LAUNCHES["mas"] == before     # no kernel on the CPU
    np.testing.assert_array_equal(
        got.numpy(), _port(port_mas, attn, in_lens, out_lens).numpy())
    meta = torch.zeros((2, 4, 3), device="meta")
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mas_ops.mas_fused(meta, lens, lens)
    with pytest.raises(TypeError, match="float32"):
        mas_ops.mas_fused(torch.zeros((2, 4, 3), dtype=torch.float64), lens,
                          lens)
    with pytest.raises(ValueError, match="contiguous"):
        mas_ops.mas_fused(torch.zeros((2, 3, 4)).transpose(1, 2), lens, lens)


def test_split_tool_stamps_every_section_of_the_kernel():
    """`tools.mas_split` times the kernel's sections by the `// ---- `
    markers in its source: each of them gets a stamp, in source order."""
    from tts_arabic_torch.ops import build
    from tts_arabic_torch.tools.mas_split import stamped
    text, labels = stamped((build.CSRC / "mas.cu").read_text())
    assert labels == ["forward pass", "forward done", "output cleared",
                      "backtrack", "end"]
    assert [f"MAS_STAMP({k});" in text for k in range(5)] == [True] * 5
    with pytest.raises(ValueError, match="stamp anchors"):
        stamped("__global__ void k() {}\n")
