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


def _rel_err(got, x, w1, b1, w2, b2, k):
    """max |kernel - plain| / max |plain|, the plain version in f32 on the
    same (possibly bf16) inputs."""
    ref = rb.resblock1_plain(x.float(), w1.float(), b1, w2.float(), b2, k,
                             DIL)
    return float((got.float() - ref).abs().max() / ref.abs().max())


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
    """Each kernel against the plain version at T = 1000, no multiple of
    any tile. The bf16 kernels (tensor cores, K in steps of 16 channels)
    take no C = 8: the wrapper refuses it."""
    monkeypatch.setattr(rb, "variant", lambda c: variant)
    T = 1000
    x, w1, b1, w2, b2 = _case(C, k, T, dtype)
    before = rb.LAUNCHES[variant]
    if dtype == torch.bfloat16 and C == 8:
        with pytest.raises(ValueError, match="no resblock1_narrow kernel"):
            rb.resblock1(x, w1, b1, w2, b2, k, DIL)
        assert rb.LAUNCHES[variant] == before
        return
    got = rb.resblock1(x, w1, b1, w2, b2, k, DIL)
    torch.cuda.synchronize()
    assert rb.LAUNCHES[variant] == before + (3 if variant.endswith("wide")
                                             else 1)
    assert got.dtype == dtype and got.shape == x.shape
    rel = _rel_err(got, x, w1, b1, w2, b2, k)
    assert rel <= TOL[dtype], rel


@pytest.mark.cuda
def test_short_sequences_and_edges(cuda):
    """T shorter than a tile and than the halo: the SAME zero padding at
    both ends comes from the mask alone, in both kernels' dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        for C, T in ((256, 5), (128, 1), (64, 20), (32, 7), (32, 130)):
            x, w1, b1, w2, b2 = _case(C, 11, T, dtype, seed=T)
            got = rb.resblock1(x, w1, b1, w2, b2, 11, DIL)
            torch.cuda.synchronize()
            rel = _rel_err(got, x, w1, b1, w2, b2, 11)
            assert rel <= TOL[dtype], (C, T, dtype, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,C", [
    ("resblock1_wide", 256), ("resblock1_wide", 128), ("resblock1_wide", 64),
    ("resblock1_narrow", 64), ("resblock1_narrow", 32),
    ("resblock1_narrow", 16)])
def test_bf16_ragged_tiles_and_one_row(cuda, variant, C, monkeypatch):
    """bf16, B = 1 and T = 1237: more than one tile of every kernel (wide
    tiles are 128/256/512 rows less the halo, narrow 512 or 256), no
    multiple of 16, so the last tile and its last m-tile are ragged."""
    monkeypatch.setattr(rb, "variant", lambda c: variant)
    for k in (3, 11):
        g = torch.Generator().manual_seed(k)
        x = torch.randn((1, 1237, C), generator=g)
        w1, w2 = (torch.randn((3, C, C, k), generator=g) / (k * C) ** 0.5
                  for _ in range(2))
        b1, b2 = (0.1 * torch.randn((3, C), generator=g) for _ in range(2))
        x, w1, w2 = (t.cuda().to(torch.bfloat16) for t in (x, w1, w2))
        b1, b2 = b1.cuda(), b2.cuda()
        got = rb.resblock1(x, w1, b1, w2, b2, k, DIL)
        torch.cuda.synchronize()
        rel = _rel_err(got, x, w1, b1, w2, b2, k)
        assert rel <= TOL[torch.bfloat16], (k, rel)


@pytest.mark.cuda
def test_unsupported_width_raises(cuda):
    x, w1, b1, w2, b2 = _case(48, 3, 50, torch.float32)
    with pytest.raises(ValueError, match="no resblock1_wide kernel"):
        rb.resblock1(x, w1, b1, w2, b2, 3, DIL)
    # the bf16 kernels read x 16 bytes at once
    x, w1, b1, w2, b2 = _case(64, 3, 50, torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    shifted = shifted[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte boundary"):
        rb.resblock1(shifted, w1, b1, w2, b2, 3, DIL)


def _mas_case(B, T_mel, T_txt, seed):
    """Log-softmaxed random scores; random lengths in [1, T], the first row
    at full size and, where T_mel < T_txt allows it, rows with out_len <
    in_len (no monotonic path)."""
    g = torch.Generator().manual_seed(seed)
    log_attn = torch.log_softmax(
        3.0 * torch.randn((B, T_mel, T_txt), generator=g), dim=-1)
    in_lens = torch.randint(1, T_txt + 1, (B,), generator=g)
    out_lens = torch.randint(1, T_mel + 1, (B,), generator=g)
    in_lens[0], out_lens[0] = T_txt, T_mel
    if B > 1:
        in_lens[-1] = T_txt
        out_lens[-1] = max(1, min(T_mel, T_txt - 1))
    return log_attn, in_lens, out_lens


@pytest.mark.cuda
@pytest.mark.parametrize("B,T_mel,T_txt", [
    (3, 50, 7), (4, 300, 33), (2, 64, 1), (2, 1, 9), (4, 1000, 300),
    (5, 777, 257), (6, 1850, 368), (2, 130, 1024), (3, 20, 64),
    # odd widths: rows start off a 16-byte boundary (a stage's bulk copy
    # starts at the boundary before its first row)
    (3, 200, 37), (2, 333, 145),
    # several consumer warps
    (2, 40, 1025), (2, 30, 2100), (1, 16, 8192),
    # direction bits spilled to the global scratch
    (2, 6000, 1200)])
def test_mas_kernel_bit_equal_to_plain(cuda, B, T_mel, T_txt):
    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.ops import mas as mas_ops
    log_attn, in_lens, out_lens = _mas_case(B, T_mel, T_txt, seed=T_mel)
    ref = mas_plain(log_attn, in_lens, out_lens)
    before = mas_ops.LAUNCHES["mas"]
    got = mas_ops.mas_fused(log_attn.cuda(), in_lens.cuda(),
                            out_lens.cuda())
    torch.cuda.synchronize()
    assert mas_ops.LAUNCHES["mas"] == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got.cpu(), ref)
    # and against the plain version run on the card
    assert torch.equal(got, mas_plain(log_attn.cuda(), in_lens.cuda(),
                                      out_lens.cuda()))


@pytest.mark.cuda
def test_mas_kernel_writes_its_whole_output(cuda):
    """Rows with no path (in_len outside [1, T_txt], out_len < 1) come back
    all zero, out_len > T_mel is cut to T_mel, and nothing of a reused
    allocation survives: the wrapper no longer clears the output. The
    log-attention starts 4 bytes past a 16-byte boundary, so every stage
    of rows is copied from the boundary before it."""
    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.ops import mas as mas_ops
    B, T_mel, T_txt = 6, 90, 40
    log_attn, _, _ = _mas_case(B, T_mel, T_txt, seed=3)
    buf = torch.empty(log_attn.numel() + 1, device="cuda")
    shifted = buf[1:].view(log_attn.shape)
    shifted.copy_(log_attn)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    in_lens = torch.tensor([40, 0, 41, 12, 7, 40], dtype=torch.int32)
    out_lens = torch.tensor([90, 50, 60, 0, 200, 3], dtype=torch.int32)
    ref = mas_plain(log_attn, in_lens, out_lens)
    # freed at once: the allocator hands its block to the output next
    torch.full((B, T_mel, T_txt), float("nan"), device="cuda")
    got = mas_ops.mas_fused(shifted, in_lens.cuda(), out_lens.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert got[1:4].abs().sum() == 0


@pytest.mark.cuda
def test_mas_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from tts_arabic_torch.ops import mas as mas_ops
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    limit = mas_ops.MAX_TEXT_LEN
    assert limit >= 8192
    before = mas_ops.LAUNCHES["mas"]
    with pytest.raises(ValueError, match=f"T_txt <= {limit}"):
        mas_ops.mas_fused(torch.zeros((2, 4, limit + 1), device="cuda"),
                          lens, lens)
    assert mas_ops.LAUNCHES["mas"] == before
    # the widest row the kernel takes runs on it
    got = mas_ops.mas_fused(torch.zeros((2, 4, limit), device="cuda"),
                            lens, lens)
    torch.cuda.synchronize()
    assert mas_ops.LAUNCHES["mas"] == before + 1 and got.sum() == 2
    with pytest.raises(ValueError, match="contiguous"):
        mas_ops.mas_fused(torch.zeros((2, 8, 4), device="cuda").transpose(
            1, 2), lens, lens)
    with pytest.raises(TypeError, match="float32"):
        mas_ops.mas_fused(torch.zeros((2, 4, 8), device="cuda",
                                      dtype=torch.float64), lens, lens)


@pytest.mark.cuda
def test_train_step_runs_mas_on_the_kernel(cuda):
    """A tiny FastPitch train step on the card launches the MAS kernel once
    and gives the loss of the same step with MAS on the plain version."""
    import contextlib
    import copy
    from unittest import mock

    import numpy as np

    from tts_arabic_torch.align.mas import mas as mas_plain
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.train import steps
    rng = np.random.default_rng(0)
    B, T_txt, T_mel = 3, 32, 192
    token_lens = np.array([32, 20, 9], np.int32)
    mel_lens = np.array([192, 150, 40], np.int32)
    tokens = rng.integers(1, 40, (B, T_txt)).astype(np.int32)
    mel = rng.standard_normal((B, T_mel, 80)).astype(np.float32) - 4.0
    for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
        tokens[i, nt:] = 0
        mel[i, nm:] = 0.0
    batch = {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
             "mel_lens": mel_lens,
             "pitch_dense": rng.standard_normal((B, 1, T_mel)).astype(
                 np.float32),
             "energy_dense": np.abs(rng.standard_normal((B, T_mel))).astype(
                 np.float32),
             "attn_prior": np.full((B, T_mel, T_txt), 1.0 / T_txt,
                                   np.float32)}
    cfg = FastPitchConfig(d_model=64, enc_n_layers=2, dec_n_layers=2,
                          enc_filter_size=128, dec_filter_size=128)
    base = init_weights(FastPitch(cfg), 0).cuda()
    losses = []
    for plain in (False, True):
        model = copy.deepcopy(base)
        state = steps.TrainState(model, steps.make_optimizer(model))
        before = mas_ops.LAUNCHES["mas"]
        with (mock.patch.object(mas_ops, "mas_fused", mas_plain) if plain
              else contextlib.nullcontext()):
            meta = steps.make_fastpitch_train_step(device="cuda")(
                state, batch, 0)
        torch.cuda.synchronize()
        assert mas_ops.LAUNCHES["mas"] == before + (0 if plain else 1)
        assert state.step == 1 and torch.isfinite(meta["loss"])
        losses.append(float(meta["loss"]))
    assert losses[0] == losses[1]
