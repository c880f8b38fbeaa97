"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU with nvcc; every test skips without one. Imports no
JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_cuda.py
"""
import pytest
import torch

from tts_arabic_torch.ops import resblock as rb

DIL = (1, 3, 5)
# max |kernel - plain| / max |plain|: f32 differs by summation order only
# (plain with TF32 off); bf16 rounds every conv output and residual to
# bf16, against a plain reference in f32 on the same bf16 inputs
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _case(C, k, T, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, T, C), generator=g)
    w1, w2 = (torch.randn((3, C, C, k), generator=g) / (k * C) ** 0.5
              for _ in range(2))
    b1, b2 = (0.1 * torch.randn((3, C), generator=g) for _ in range(2))
    return (x.cuda().to(dtype), w1.cuda().to(dtype), b1.cuda(),
            w2.cuda().to(dtype), b2.cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("variant,C", [
    ("resblock1_wide", 256), ("resblock1_wide", 128), ("resblock1_wide", 64),
    ("resblock1_narrow", 64), ("resblock1_narrow", 32),
    ("resblock1_narrow", 16), ("resblock1_narrow", 8)])
def test_resblock1_kernel_matches_plain(cuda, variant, C, k, dtype,
                                        monkeypatch):
    monkeypatch.setattr(rb, "variant", lambda c: variant)
    T = 1000                  # no multiple of any tile
    x, w1, b1, w2, b2 = _case(C, k, T, dtype)
    before = rb.LAUNCHES[variant]
    got = rb.resblock1(x, w1, b1, w2, b2, k, DIL)
    torch.cuda.synchronize()
    assert rb.LAUNCHES[variant] == before + (3 if variant.endswith("wide")
                                             else 1)
    assert got.dtype == dtype and got.shape == x.shape
    ref = rb.resblock1_plain(x.float(), w1.float(), b1, w2.float(), b2, k,
                             DIL)
    rel = float((got.float() - ref).abs().max() / ref.abs().max())
    assert rel <= TOL[dtype], rel


@pytest.mark.cuda
def test_short_sequences_and_edges(cuda):
    """T shorter than a tile and than the halo: the SAME zero padding at
    both ends comes from the mask alone."""
    for C, T in ((256, 5), (128, 1), (32, 7), (32, 130)):
        x, w1, b1, w2, b2 = _case(C, 11, T, torch.float32, seed=T)
        got = rb.resblock1(x, w1, b1, w2, b2, 11, DIL)
        ref = rb.resblock1_plain(x, w1, b1, w2, b2, 11, DIL)
        torch.cuda.synchronize()
        rel = float((got - ref).abs().max() / ref.abs().max())
        assert rel <= TOL[torch.float32], (C, T, rel)


@pytest.mark.cuda
def test_unsupported_width_raises(cuda):
    x, w1, b1, w2, b2 = _case(48, 3, 50, torch.float32)
    with pytest.raises(ValueError, match="no resblock1_wide kernel"):
        rb.resblock1(x, w1, b1, w2, b2, 3, DIL)
