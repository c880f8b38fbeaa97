"""ResBlock1: the port's plain version (what `resblock1` runs on a CPU
tensor) against the JAX package's Pallas kernels in interpret mode and the
flax module, on the same numpy-seeded inputs and weights; the TPU kernels
in bf16 against the tolerance the card holds the CUDA kernels to; and the
weight layout the kernels read. The CUDA kernel itself is held against the
plain version on the card by `tests/test_torch_port_cuda.py` and
`chip_smoke.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.ops import resblock as port_rb
from tts_arabic_tpu.ops.hifigan_pallas import (resblock_pallas,
                                               resblock_pallas_packed)
from tts_arabic_tpu.vocoder.hifigan import ResBlock1

DIL = (1, 3, 5)
# bf16 kernel vs the plain version in f32 on the same bf16 inputs:
# max |kernel - plain| <= TOL_BF16 * max |plain| (chip_smoke.py's TOL)
TOL_BF16 = 3e-2


def _case(C, k, T=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    params = {}
    for i in range(len(DIL)):
        for name in ("conv1", "conv2"):
            params[f"{name}_{i}"] = {
                "kernel": (rng.standard_normal((k, C, C))
                           / np.sqrt(k * C)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
    return x, params


def _torch_weights(params, name):
    """flax kernels [k, C_in, C_out] -> stacked Conv1d weights
    [n_d, C_out, C_in, k] and biases [n_d, C]."""
    w = np.stack([params[f"{name}_{i}"]["kernel"].transpose(2, 1, 0)
                  for i in range(len(DIL))])
    b = np.stack([params[f"{name}_{i}"]["bias"] for i in range(len(DIL))])
    return torch.from_numpy(np.ascontiguousarray(w)), torch.from_numpy(b)


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [32, 64, 128])
def test_resblock1_matches_pallas_and_flax(C, k):
    x, params = _case(C, k)
    ref_flax = np.asarray(ResBlock1(C, k, DIL).apply({"params": params},
                                                     jnp.asarray(x)))
    ref_pallas = np.asarray(resblock_pallas(jnp.asarray(x), params, k, DIL,
                                            interpret=True))
    w1, b1 = _torch_weights(params, "conv1")
    w2, b2 = _torch_weights(params, "conv2")
    before = dict(port_rb.LAUNCHES)
    got = port_rb.resblock1(torch.from_numpy(x), w1, b1, w2, b2, k,
                            DIL).numpy()
    assert port_rb.LAUNCHES == before     # CPU tensors launch no kernel
    plain = port_rb.resblock1_plain(torch.from_numpy(x), w1, b1, w2, b2, k,
                                    DIL).numpy()
    np.testing.assert_array_equal(got, plain)
    # tolerance: f32 reassociation noise amplified by the 6-conv residual
    # chain + leaky-relu kinks (as tests/test_ops.py holds the Pallas kernel)
    for ref in (ref_flax, ref_pallas):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)
        assert float(np.abs(got - ref).mean()) < 1e-4


@pytest.mark.parametrize("bad", ["dtype", "layout", "weights", "kernel"])
def test_resblock1_checks_its_arguments(bad):
    x, params = _case(32, 3, T=40)
    x = torch.from_numpy(x)
    w1, b1 = _torch_weights(params, "conv1")
    w2, b2 = _torch_weights(params, "conv2")
    k = 3
    if bad == "dtype":
        x, err = x.double(), TypeError
    elif bad == "layout":
        x, err = x.transpose(1, 2).contiguous().transpose(1, 2), ValueError
    elif bad == "weights":
        w1, err = w1[:, :, :16], ValueError
    else:
        k, err = 4, ValueError
    with pytest.raises(err):
        port_rb.resblock1(x, w1, b1, w2, b2, k, DIL)


def test_variant_by_width():
    assert port_rb.variant(32) == "resblock1_narrow"
    for C in (64, 128, 256):
        assert port_rb.variant(C) == "resblock1_wide"


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, kept as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [32, 64, 128])
def test_bf16_tpu_kernel_within_the_card_tolerance(C, k):
    """The TPU kernel in bf16 (`resblock_pallas_packed` at C = 32, as the
    JAX package serves that stage, else `resblock_pallas`; interpret mode,
    two tiles) against the port's plain version in f32 on the same
    bf16-rounded x and weights (f32 biases, as both kernels take them):
    the TPU kernel's own bf16 rounding stays within the tolerance that the
    card holds the CUDA kernels to."""
    x, params = _case(C, k)
    x = _bf16(x)
    for p in params.values():
        p["kernel"] = _bf16(p["kernel"])
    fn = resblock_pallas_packed if C == 32 else resblock_pallas
    got = np.asarray(fn(jnp.asarray(x, jnp.bfloat16), params, k, DIL,
                        t_tile=256, interpret=True).astype(jnp.float32))
    w1, b1 = _torch_weights(params, "conv1")
    w2, b2 = _torch_weights(params, "conv2")
    plain = port_rb.resblock1_plain(torch.from_numpy(x), w1, b1, w2, b2, k,
                                    DIL).numpy()
    assert got.shape == plain.shape
    rel = float(np.abs(got - plain).max() / np.abs(plain).max())
    assert rel <= TOL_BF16, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_weights_rebuild_the_conv_weights(dtype):
    """`kernel_weights` lays the stacked Conv1d weights out as the kernels
    read them: exactly invertible, and as the [k*C_in, C_out] matrix of an
    implicit-GEMM conv it gives F.conv1d's result."""
    C_out, C_in, k, d = 16, 8, 5, 3
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2, C_out, C_in, k), generator=g).to(dtype).float()
    kw = port_rb.kernel_weights(w, dtype)
    assert kw.dtype == dtype and kw.is_contiguous()
    assert tuple(kw.shape) == (2, k, C_in, C_out)
    assert torch.equal(kw.float().permute(0, 3, 2, 1), w)
    # out[t, co] = sum_j sum_ci a[t + (j - r) d, ci] W[j C_in + ci, co]
    a = torch.randn((1, 40, C_in), generator=g)
    r = (k - 1) // 2
    ap = torch.nn.functional.pad(a, (0, 0, r * d, r * d))
    cols = torch.cat([ap[:, j * d: j * d + 40] for j in range(k)], dim=-1)
    for i in range(2):
        gemm = cols @ kw[i].float().reshape(k * C_in, C_out)
        conv = torch.nn.functional.conv1d(a.transpose(1, 2), w[i],
                                          dilation=d, padding=r * d)
        torch.testing.assert_close(gemm, conv.transpose(1, 2), atol=1e-5,
                                   rtol=1e-5)


def test_kernel_weights_kept_until_the_weights_change():
    """The same weights give the same converted tensor until they change in
    place or another dtype is asked for; the result stays right each time."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn((3, 8, 8, 3), generator=g)
    first = port_rb.kernel_weights(w, torch.bfloat16)
    assert port_rb.kernel_weights(w, torch.bfloat16) is first
    f32 = port_rb.kernel_weights(w, torch.float32)
    assert f32 is not first and f32.dtype == torch.float32
    assert torch.equal(f32.permute(0, 3, 2, 1), w)
    with torch.no_grad():
        w.mul_(2.0)
    again = port_rb.kernel_weights(w, torch.float32)
    assert again is not f32
    assert torch.equal(again.permute(0, 3, 2, 1), w)
    # a weight that records gradients is converted afresh each call
    w.requires_grad_(True)
    with torch.enable_grad():
        a = port_rb.kernel_weights(w, torch.float32)
        assert a.requires_grad
        assert port_rb.kernel_weights(w, torch.float32) is not a
