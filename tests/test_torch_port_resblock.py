"""ResBlock1: the port's plain version (what `resblock1` runs on a CPU
tensor) against the JAX package's Pallas kernel in interpret mode and the
flax module, on the same numpy-seeded inputs and weights. The CUDA kernel
itself is held against the plain version on the card by
`tests/test_torch_port_cuda.py` and `chip_smoke.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.ops import resblock as port_rb
from tts_arabic_tpu.ops.hifigan_pallas import resblock_pallas
from tts_arabic_tpu.vocoder.hifigan import ResBlock1

DIL = (1, 3, 5)


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
