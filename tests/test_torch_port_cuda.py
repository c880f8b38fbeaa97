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


F32_VARIANTS = [
    ("resblock1_wide", 256), ("resblock1_wide", 128), ("resblock1_wide", 64),
    ("resblock1_narrow", 64), ("resblock1_narrow", 32),
    ("resblock1_narrow", 16), ("resblock1_narrow", 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("variant,C", F32_VARIANTS)
def test_f32_kernel_rows_do_not_depend_on_their_tile(cuda, variant, C, k,
                                                     monkeypatch):
    """f32 (3xTF32): the rows of a call at T = 1000 that its end does not
    reach (all but the block's halo) are bit-equal to the same rows inside
    a longer call that starts with the same 1000 rows; the rows its start
    does not reach to those of a call that starts 37 rows earlier, where
    every row lies in another tile, m-tile and lane; and its two batch rows
    to the first two of a call of eight (a grid that may take the other
    wide tile height). Each row's sum runs in one order wherever a call
    cuts the sequence (the stream windows against the whole call)."""
    monkeypatch.setattr(rb, "variant", lambda c: variant)
    halo = (k - 1) // 2 * sum(d + 1 for d in DIL)
    x = _case(C, k, 1296, torch.float32, seed=k)[0]
    x8, w1, b1, w2, b2 = _case(C, k, 1000, torch.float32, seed=k + 2)
    x8 = x8.repeat(4, 1, 1)
    x8[:2] = x[:, 37:1037]

    def run(t0, t1):
        return rb.resblock1(x[:, t0:t1].contiguous(), w1, b1, w2, b2, k, DIL)
    ref = run(37, 1037)
    longer = run(37, 1296)
    earlier = run(0, 1037)
    eight = rb.resblock1(x8, w1, b1, w2, b2, k, DIL)
    torch.cuda.synchronize()
    assert torch.equal(longer[:, :1000 - halo], ref[:, :1000 - halo])
    assert torch.equal(earlier[:, 37 + halo:], ref[:, halo:])
    assert torch.equal(eight[:2], ref)
    assert not torch.equal(longer[:, :1000], ref)   # the end does reach


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("variant,C", F32_VARIANTS)
def test_f32_kernel_as_close_to_float64_as_plain_f32(cuda, variant, C, k,
                                                     monkeypatch):
    """f32 (3xTF32) anchored to float64: the kernel's largest distance from
    the plain version run in float64 on the card is at most twice that of
    the plain version in f32 (TF32 off). One TF32 product a term would be
    about a thousand times as far (tests/test_torch_port_resblock_tf32.py)."""
    monkeypatch.setattr(rb, "variant", lambda c: variant)
    x, w1, b1, w2, b2 = _case(C, k, 1000, torch.float32, seed=k + 1)
    got = rb.resblock1(x, w1, b1, w2, b2, k, DIL)
    plain = rb.resblock1_plain(x, w1, b1, w2, b2, k, DIL)
    exact = rb.resblock1_plain(*(t.double() for t in (x, w1, b1, w2, b2)),
                               k, DIL)
    torch.cuda.synchronize()
    d_kernel = float((got.double() - exact).abs().max())
    d_plain = float((plain.double() - exact).abs().max())
    assert d_kernel <= 2 * d_plain, (d_kernel, d_plain)


@pytest.mark.cuda
def test_f32_kernels_split_as_the_cpu_model(cuda):
    """The f32 kernels' split of an operand (cvt.rna.tf32.f32, a subtract,
    cvt.rna.tf32.f32 again) on the card, word for word the plain version
    that tests/test_torch_port_resblock_tf32.py holds to its numpy model:
    ties, carries, subnormals, signed zeros, the largest magnitudes, and
    random words of every exponent (the small part of +-inf is NaN on both
    sides)."""
    words = [0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F801001, 0xBF801000,
             0x3F803000, 0x3FFFF000, 0xBFFFFFFF, 0x00000000, 0x80000000,
             0x00000001, 0x80000FFF, 0x00001000, 0x00345678, 0x007FF000,
             0x7F7FEFFF, 0x7F7FFFFF, 0xFF7FF000, 0x7F800000, 0xFF800000]
    g = torch.Generator().manual_seed(0)
    rand = torch.randint(-2 ** 31, 2 ** 31, (20000,), generator=g,
                         dtype=torch.int64)
    v = torch.cat([torch.tensor(words, dtype=torch.int64), rand])
    v = ((v + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).view(
        torch.float32)
    v = v[torch.isfinite(v) | (torch.arange(len(v)) < len(words))]
    want = rb.tf32_split(v)
    got = rb.tf32_split(v.to(cuda))
    torch.cuda.synchronize()
    for part, w, o in zip(("big", "small"), want, got):
        o = o.cpu()
        # inf - inf: a NaN on both, whose payload is the subtract's own
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(o), nan), part
        bad = (o.view(torch.int32) != w.view(torch.int32)) & ~nan
        assert not bad.any(), [
            (f"{a:#010x}", f"{b:#010x}", f"{c:#010x}") for a, b, c in zip(
                *(t[bad][:5].view(torch.int32).tolist() for t in (v, o, w)))]


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("C,T", [(256, 1280), (128, 10240), (64, 20480),
                                 (32, 40960)])
def test_resblock1_kernels_at_stream_shapes(cuda, C, T, dtype):
    """The shapes of one streamed window (B = 1, 160 frames at 8, 64, 128
    and 256 samples a frame), each width on the variant that serves it."""
    name = rb.variant(C)
    for k in (3, 7, 11):
        g = torch.Generator().manual_seed(C + k)
        x = torch.randn((1, T, C), generator=g)
        w1, w2 = (torch.randn((3, C, C, k), generator=g) / (k * C) ** 0.5
                  for _ in range(2))
        b1, b2 = (0.1 * torch.randn((3, C), generator=g) for _ in range(2))
        x, w1, w2 = (t.cuda().to(dtype) for t in (x, w1, w2))
        b1, b2 = b1.cuda(), b2.cuda()
        before = rb.LAUNCHES[name]
        got = rb.resblock1(x, w1, b1, w2, b2, k, DIL)
        torch.cuda.synchronize()
        assert rb.LAUNCHES[name] == before + (3 if C > 32 else 1)
        rel = _rel_err(got, x, w1, b1, w2, b2, k)
        assert rel <= TOL[dtype], (k, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_generator_side_streams_equal_one_stream(cuda, dtype):
    """HiFi-GAN V1 with each stage's ResBlocks on side streams gives, bit
    for bit, what the same kernels give one after another on one stream,
    at a window's shape and at a batch's; the kept weights follow a loaded
    state dict."""
    from unittest import mock

    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig

    def one_stream(blocks, x):
        acc = blocks[0](x)
        for block in blocks[1:]:
            acc = acc + block(x)
        return acc / len(blocks)

    gen = init_weights(Generator(HiFiGANConfig()), 1).to(cuda).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for shape in ((1, 160, 80), (4, 256, 80)):
            mel = torch.randn(shape, generator=g).to(cuda, dtype)
            before = dict(rb.LAUNCHES)
            got = gen(mel)
            assert rb.LAUNCHES["resblock1_wide"] - before[
                "resblock1_wide"] == 27
            with mock.patch.object(Generator, "_fuse",
                                   staticmethod(one_stream)):
                want = gen(mel)
            assert torch.equal(got, want), shape
        state = {k: v * 0.9 for k, v in gen.state_dict().items()}
        fresh = Generator(HiFiGANConfig()).to(cuda).eval()
        fresh.load_state_dict(state)
        gen.load_state_dict(state)
        assert torch.equal(gen(mel), fresh(mel))


# bf16 stream against tts_single: chip_smoke.py's STREAM_BF16_SNR
STREAM_BF16_SNR = 36.56
STREAM_TEXT = "bisomi {ll~ahi {lr~aHoma`ni {lr~aHiymi"


def _card_pipe(dtype=None):
    """Full-width FastPitch and HiFi-GAN V1, seeded, duration bias +2."""
    from tts_arabic_torch.infer import FastPitch2Wave
    pipe = FastPitch2Wave(seed=0, arabic_in=False, compute_dtype=dtype,
                          device="cuda")
    with torch.no_grad():
        pipe.model.model.duration_predictor.fc.bias.add_(2.0)
    return pipe


def _eager(pipe):
    """The pipeline's CUDA graphs set aside while the block runs."""
    from unittest import mock
    return mock.patch.dict(pipe.model._graphs, clear=True)


def _snr_db(ref, got):
    import numpy as np
    ref, got = ref.astype(np.float64), got.astype(np.float64)
    return float(10 * np.log10(np.mean(ref ** 2)
                               / (np.mean((ref - got) ** 2) + 1e-30)))


@pytest.mark.cuda
def test_stream_equals_tts_single_on_the_card(cuda):
    """Full-width FastPitch and HiFi-GAN V1 in f32 on the kernels: the
    streamed chunks concatenate to tts_single's wave, and both, replayed
    from the graphs, equal the eager tts_single."""
    import numpy as np
    pipe = _card_pipe()
    text = " ".join([STREAM_TEXT] * 4)
    eager = pipe.tts_single(text, denoise=0.004)
    pipe.model.capture_graphs()
    full = pipe.tts_single(text, denoise=0.004)
    before = dict(rb.LAUNCHES)
    replays = pipe.model.graph_replays
    chunks = list(pipe.stream(text, chunk_frames=48, denoise=0.004))
    assert pipe.model.graph_replays == replays + 2      # encode, decode
    assert len(chunks) >= 3
    assert rb.LAUNCHES["resblock1_wide"] - before["resblock1_wide"] == \
        27 * len(chunks)
    assert rb.LAUNCHES["resblock1_narrow"] - before["resblock1_narrow"] == \
        3 * len(chunks)
    streamed = np.concatenate(chunks)
    assert streamed.shape == full.shape == eager.shape
    assert np.abs(streamed - full).max() <= 1e-4
    assert np.abs(full - eager).max() <= 1e-4


@pytest.mark.cuda
def test_graphs_replay_any_text_and_rate(cuda):
    """The graphs are captured on placeholder tokens and scalars, so every
    replay holds other inputs: in f32, tts_single of texts in two buckets
    at other speeds, pitches and pitch shifts, and tts() at batch size 1,
    replay them and give the eager waves."""
    import numpy as np
    pipe = _card_pipe()
    pipe.model.capture_graphs()
    cases = [(STREAM_TEXT, 1.0, 1.0, 0.0),
             (STREAM_TEXT, 0.8, 1.2, 0.0),
             (" ".join([STREAM_TEXT] * 5), 1.25, 0.9, 0.3)]
    for text, speed, pitch_mul, pitch_add in cases:
        kw = dict(speed=speed, pitch_mul=pitch_mul, pitch_add=pitch_add,
                  denoise=0.004)
        replays = pipe.model.graph_replays
        got = pipe.tts_single(text, **kw)
        assert pipe.model.graph_replays == replays + 2
        with _eager(pipe):
            want = pipe.tts_single(text, **kw)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4, (speed, pitch_mul)
    texts = [c[0] for c in cases]
    for got, text in zip(pipe.tts(texts, batch_size=1, denoise=0.004),
                         texts):
        want = pipe.tts_single(text, denoise=0.004)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4


@pytest.mark.cuda
def test_stream_graphs_replay_and_interleave(cuda):
    """In bf16, two texts of one text bucket at two speeds replay the same
    encode graph: each stream holds its eager tts_single at the smoke's
    SNR gate, a second stream of a text gives the same chunks, and two
    streams of one pipeline taken in turns give what each gives alone."""
    import numpy as np
    pipe = _card_pipe(torch.bfloat16)
    pipe.model.capture_graphs(torch.bfloat16)
    text = " ".join([STREAM_TEXT] * 3)
    texts = [text, text.replace("bisomi", "basami")]
    speeds = [1.0, 0.9]
    ids = [pipe.model.tokenize(t) for t in texts]
    assert (pipe.model._text_length(len(ids[0]), 1)
            == pipe.model._text_length(len(ids[1]), 1))

    def stream(j):
        return pipe.stream(texts[j], chunk_frames=32, speed=speeds[j])

    replays = pipe.model.graph_replays
    alone = [list(stream(j)) for j in range(2)]
    assert pipe.model.graph_replays == replays + 4
    assert not all(np.array_equal(a, b) for a, b in zip(*alone))
    for j in range(2):
        with _eager(pipe):
            want = pipe.tts_single(texts[j], speed=speeds[j], denoise=0.005)
        got = np.concatenate(alone[j])
        assert got.shape == want.shape
        assert _snr_db(want, got) > STREAM_BF16_SNR, j
    again = list(stream(0))
    assert all(np.array_equal(a, b) for a, b in zip(alone[0], again))
    gens = [stream(j) for j in range(2)]
    turns = [[], []]
    for i in range(max(map(len, alone))):
        for j, g in enumerate(gens):
            if i < len(alone[j]):
                turns[j].append(next(g))
    for got, want in zip(turns, alone):
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ---- Tacotron2 ---------------------------------------------------------------

T2_TEXTS = ["Sifr wAHid", "*ahaba Alwaladu <ilaY Almadrasapi"]


def _t2_pipe(steps=300, **kw):
    """Full-width Tacotron2 and HiFi-GAN V1, seeded; the random gate never
    fires, so every decode runs to `steps`."""
    from tts_arabic_torch.infer import Tacotron2Wave
    pipe = Tacotron2Wave(seed=0, arabic_in=False, device="cuda", **kw)
    pipe.model.decoder_max_step = steps
    return pipe


def _t2_batch(pipe, texts):
    m = pipe.model
    padded, lens, spk, _, _ = m._sorted_batch(m.tokenize_batch(texts), 0,
                                              None)
    return padded, lens, spk


@pytest.mark.cuda
def test_tacotron2_graphed_block_equals_eager(cuda):
    """In f32 the replayed decode-block graph gives the eager blocks'
    lengths and outputs within 1e-5, for a batch and for a stream's
    segments (which replay the graph at batch 1)."""
    import numpy as np
    pipe = _t2_pipe()
    m = pipe.model
    padded, lens, spk = _t2_batch(pipe, T2_TEXTS)
    eager = m._infer(padded, lens, spk)
    m.capture_graphs((len(T2_TEXTS),), (padded.shape[1],))
    replays = m.graph_replays
    graphed = m._infer(padded, lens, spk)
    assert m.graph_replays > replays
    assert torch.equal(graphed["mel_lens"], eager["mel_lens"])
    for key in ("mel", "mel_postnet", "alignments", "gates"):
        assert float((graphed[key] - eager[key]).abs().max()) <= 1e-5, key

    text = T2_TEXTS[0]
    n_ids = len(m.tokenize(text))
    want = pipe.tts_single(text, denoise=0.004, postprocess_mel=False)
    m.capture_graphs((1,), (-(-n_ids // 16) * 16,))
    replays = m.graph_replays
    got = np.concatenate(list(pipe.stream(text, chunk_frames=64,
                                          denoise=0.004)))
    assert m.graph_replays > replays
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.cuda
def test_tacotron2_replays_draw_the_callers_dropout_masks(cuda):
    """The prenet masks are an input of the graph, not state inside it:
    replays with two generator seeds differ, a seed replayed twice gives
    the same outputs, and a replay equals the eager decode with the same
    masks."""
    pipe = _t2_pipe(steps=200)
    m = pipe.model
    padded, lens, spk = _t2_batch(pipe, T2_TEXTS)

    def decode(seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        return m._infer(padded, lens, spk, gen)["mel"]
    eager = decode(1)
    m.capture_graphs((len(T2_TEXTS),), (padded.shape[1],))
    a, b, c = decode(1), decode(1), decode(2)
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-3
    assert float((a - eager).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_tacotron2_tts_runs_the_resblock_kernels(cuda):
    """Tacotron2Wave.tts() in f32 vocodes through the ResBlock kernels (27
    wide and 3 narrow launches per generator call) and its waves hold the
    plain ResBlocks' above 40 dB."""
    import numpy as np
    from unittest import mock

    from tts_arabic_torch.vocoder import hifigan
    pipe = _t2_pipe(steps=400)
    rb.reset_launches()
    kern = pipe.tts(T2_TEXTS, batch_size=2, denoise=0.005)
    assert rb.LAUNCHES == {"resblock1_wide": 27, "resblock1_narrow": 3}
    with mock.patch.object(hifigan, "resblock1", rb.resblock1_plain):
        plain = pipe.tts(T2_TEXTS, batch_size=2, denoise=0.005)
    for k, p in zip(kern, plain):
        assert k.shape == p.shape and len(k) > 0
        assert _snr_db(p, k) > 40.0


# ---- the int8 path and Vocos ------------------------------------------------

def _fake_quant_oracle(y, weight, bias, dilation, ascale):
    """The int8 conv in float64 from its grids: (the exact int32
    accumulators as f64, acc * (ascale * wscale) + bias)."""
    from tts_arabic_torch.ops import int8 as i8
    xq = i8.quantize(y, ascale).double()
    wq, wscale = i8.weight_qparams(weight)
    k = weight.shape[-1]
    acc = torch.nn.functional.conv1d(
        xq.transpose(1, 2), wq.double(), dilation=dilation,
        padding=dilation * (k - 1) // 2).transpose(1, 2)
    scale = torch.as_tensor(ascale, dtype=torch.float32).double()
    return acc, acc * (scale * wscale.double()) + bias.double()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("C_in,C_out,k,d,T", [
    (256, 256, 3, 5, 1280), (256, 256, 11, 3, 1280), (128, 128, 7, 1, 2560),
    (64, 64, 11, 5, 5120), (384, 1536, 3, 1, 512), (1536, 384, 3, 1, 512),
    (64, 64, 3, 1, 2)], ids=["s0k3", "s0k11", "s1k7", "s2k11", "ffn1",
                             "ffn2", "16rows"])
def test_int8_conv_matches_the_oracle(cuda, C_in, C_out, k, d, T, batch):
    """`torch._int_mm` on the card at the MRF stages' shapes (one streamed
    window's at B = 1, a tts() batch's at B = 8) and the decoder FFN's:
    the int32 accumulators equal the float64 conv of the grids exactly,
    the outputs within 1e-6 of its peak, for a python-float scale and an
    f32 tensor one, in f32 and bf16 inputs; and fewer than 17 rows."""
    from tts_arabic_torch.ops import int8 as i8
    g = torch.Generator().manual_seed(C_in + k + d)
    y = (torch.randn((batch, T, C_in), generator=g) * 2).to(cuda)
    weight = (torch.randn((C_out, C_in, k), generator=g)
              / (k * C_in) ** 0.5).to(cuda)
    bias = (0.1 * torch.randn((C_out,), generator=g)).to(cuda)
    amax = float(y.abs().max())
    for ascale in (amax / 127.0, torch.tensor(amax / 127.0, device=cuda)):
        for dtype in (torch.float32, torch.bfloat16):
            x = y.to(dtype)
            acc_ref, out_ref = _fake_quant_oracle(x.float(), weight, bias,
                                                  d, ascale)
            wq, _ = i8.gemm_weight(weight)
            acc = i8.int8_conv_acc(i8.quantize(x, ascale), wq, k, d)
            assert acc.dtype == torch.int32
            assert torch.equal(acc.double(), acc_ref)
            out = i8.int8_conv_static(x, weight, bias, d, ascale)
            assert out.dtype == dtype
            tol = 1e-6 if dtype == torch.float32 else 8e-3
            err = (out.double() - out_ref).abs().max() / out_ref.abs().max()
            assert err <= tol, (dtype, float(err))


@pytest.mark.cuda
def test_int8_generator_launches_the_narrow_kernel(cuda):
    """HiFi-GAN V1 in bf16 with its C >= 64 stages in int8: each call
    launches no wide ResBlock kernel and the narrow one 3 times (the
    C = 32 stage), and holds its plain version with the same scales above
    40 dB."""
    from unittest import mock

    from tts_arabic_torch.ops import hifigan_int8 as h8
    from tts_arabic_torch.vocoder import hifigan
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    from tts_arabic_torch.models.layers import init_weights
    gen = init_weights(Generator(HiFiGANConfig()), 1).to(cuda).eval()
    g = torch.Generator().manual_seed(0)
    mel = (torch.randn((2, 64, 80), generator=g) * 1.5 - 5).to(cuda)
    mel = mel.to(torch.bfloat16)
    with torch.no_grad():
        scales = h8.collect_mrf_scales(gen, mel)
        assert len(scales) == 54
        before = dict(rb.LAUNCHES)
        got = h8.generator_apply_int8(gen, mel, scales)
        torch.cuda.synchronize()
        assert rb.LAUNCHES["resblock1_wide"] == before["resblock1_wide"]
        assert rb.LAUNCHES["resblock1_narrow"] - before[
            "resblock1_narrow"] == 3
        plain = lambda x, *a: rb.resblock1_plain(  # noqa: E731
            x.float(), *(t.float() for t in a[:4]), *a[4:]).to(x.dtype)
        with mock.patch.object(hifigan, "resblock1", plain):
            want = h8.generator_apply_int8(gen, mel, scales)
    assert _snr_db(want.float().cpu().numpy(),
                   got.float().cpu().numpy()) > 40.0


@pytest.mark.cuda
def test_int8_calibrate_after_warmup_replays_int8_graphs(cuda):
    """warmup() captures the float decoder's graphs; calibrate_int8 drops
    them and captures the int8 FFN's: the graphed tts_single then equals
    the eager int8 call, and stream() replays the same graphs."""
    import numpy as np
    pipe = _card_pipe(torch.bfloat16)
    pipe.warmup(batch_sizes=(1,), text_buckets=(16,), mel_buckets=(256,))
    assert any(key[0] == "decode" and not key[-1]
               for key in pipe.model._graphs)
    pipe.calibrate_int8()
    keys = [key for key in pipe.model._graphs if key[0] == "decode"]
    assert keys and all(key[-1] for key in keys)
    replays = pipe.model.graph_replays
    got = pipe.tts_single(STREAM_TEXT, denoise=0.005)
    assert pipe.model.graph_replays == replays + 2
    with _eager(pipe):
        want = pipe.tts_single(STREAM_TEXT, denoise=0.005)
    np.testing.assert_array_equal(got, want)
    streamed = np.concatenate(list(pipe.stream(STREAM_TEXT, denoise=0.005)))
    assert streamed.shape == got.shape
    assert _snr_db(got, streamed) > 30.0


@pytest.mark.cuda
def test_vocos_matches_its_cpu_run(cuda):
    """MelVocosModule (CONFIG_22K, seeded) on the card in f32, TF32 off,
    against the same weights on the CPU: within 1e-4 of the peak."""
    from tts_arabic_torch.vocoder.vocos import (CONFIG_22K, MelVocosModule,
                                                init_vocos)
    module = init_vocos(MelVocosModule(**{
        k: v for k, v in CONFIG_22K.items() if k != "sample_rate"}), 1)
    g = torch.Generator().manual_seed(0)
    mel = torch.randn((2, 300, 80), generator=g) * 2 - 4
    with torch.no_grad():
        bias = module.bias_vector()
        want = module(mel, bias, 0.005)
        card = module.to(cuda)
        got = card(mel.to(cuda), card.bias_vector(), 0.005).cpu()
    assert got.shape == want.shape == (2, 300 * 256)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def _adv_batch(B=3, T_txt=24, T_mel=192, seed=0):
    """A FastPitch batch whose rows are shorter than a critic chunk
    (negative offsets) and longer."""
    import numpy as np
    rng = np.random.default_rng(seed)
    token_lens = np.array([24, 15, 6], np.int32)[:B]
    mel_lens = np.array([192, 100, 40], np.int32)[:B]
    tokens = rng.integers(1, 40, (B, T_txt)).astype(np.int32)
    mel = rng.standard_normal((B, T_mel, 80)).astype(np.float32) - 4.0
    for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
        tokens[i, nt:] = 0
        mel[i, nm:] = 0.0
    return {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
            "mel_lens": mel_lens,
            "pitch_dense": rng.standard_normal((B, 1, T_mel)).astype(
                np.float32),
            "energy_dense": np.abs(rng.standard_normal((B, T_mel))).astype(
                np.float32),
            "attn_prior": np.full((B, T_mel, T_txt), 1.0 / T_txt,
                                  np.float32)}


@pytest.mark.cuda
def test_adversarial_step_on_the_card_matches_the_cpu(cuda):
    """One adversarial FastPitch step (the critic's update, then the
    generator's against the updated critic) on the card and on the CPU from
    the same weights, batch and chunks (the step draws them on the CPU),
    dropouts off: equal MAS (one kernel launch), loss terms within 1e-4
    relative, critic parameters within 1e-5, vectors within 1e-6."""
    import copy
    import dataclasses

    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.ops import mas as mas_ops
    from tts_arabic_torch.train import gan, steps
    cfg = FastPitchConfig(d_model=64, enc_n_layers=2, dec_n_layers=2,
                          enc_filter_size=128, dec_filter_size=128)
    cfg = dataclasses.replace(cfg, **{f.name: 0.0 for f in
                                      dataclasses.fields(cfg)
                                      if "drop" in f.name})
    base = init_weights(FastPitch(cfg), 0)
    critic = gan.PatchDiscriminator(8)
    spectral = gan.init_critic(critic, 1)
    runs = {}
    for dev in ("cpu", cuda):
        model = copy.deepcopy(base).to(dev)
        d = copy.deepcopy(critic).to(dev)
        state = steps.TrainState(
            model, steps.make_optimizer(model, 1e-4), critic=d,
            d_optimizer=steps.make_optimizer(d, 1e-4),
            spectral={k: v.to(dev) for k, v in spectral.items()})
        before = mas_ops.LAUNCHES["mas"]
        meta = steps.make_fastpitch_train_step(device=dev)(
            state, _adv_batch(), 3)
        torch.cuda.synchronize()
        launched = mas_ops.LAUNCHES["mas"] - before
        runs[str(dev)] = (meta, state, launched)
    (m_cpu, s_cpu, n_cpu), (m_gpu, s_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    assert (n_cpu, n_gpu) == (0, 1)
    assert set(m_cpu) == set(m_gpu) and "loss_d" in m_gpu
    for k in m_cpu:
        assert torch.isfinite(m_gpu[k])
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                   atol=1e-6, msg=k)
    for name, v in s_cpu.critic.state_dict().items():
        torch.testing.assert_close(s_gpu.critic.state_dict()[name].cpu(), v,
                                   rtol=0, atol=1e-5, msg=name)
    for k, u in s_cpu.spectral.items():
        torch.testing.assert_close(s_gpu.spectral[k].cpu(), u, rtol=0,
                                   atol=1e-6, msg=k)


@pytest.mark.cuda
def test_short_mel_chunks_on_the_card(cuda):
    """Mels shorter than a chunk give negative offsets: the gather wraps
    and clamps on the card as on the CPU (no device-side assert), and the
    gradient reaches the same frames."""
    from tts_arabic_torch.train import gan
    g = torch.Generator().manual_seed(0)
    mel = torch.randn((4, 64, 80), generator=g)
    lens = torch.tensor([64, 40, 9, 1])
    ids, ofx = gan.sample_chunk_params(torch.Generator().manual_seed(1), 4,
                                       lens, gan.CHUNK_LEN)
    assert (ofx < 0).all()
    out = {}
    for dev in ("cpu", cuda):
        x = mel.to(dev).detach().requires_grad_()
        chunks = gan.extract_chunks(x, ofx.to(dev), ids.to(dev),
                                    gan.CHUNK_LEN)
        (chunks * 2.0).sum().backward()
        torch.cuda.synchronize()
        out[str(dev)] = (chunks.detach().cpu(), x.grad.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


@pytest.mark.cuda
def test_tacotron2_train_forward_on_the_card_matches_the_cpu(cuda):
    """The Tacotron2 training forward (dropouts off: the config's rates 0
    and the conv-block dropout patched out) and one step's BatchNorm
    statistics on the card, TF32 off, against the CPU: outputs within
    1e-4 of their peak, statistics within 1e-5; the backward runs through
    cuDNN's packed LSTM."""
    import copy
    from unittest import mock

    from tts_arabic_torch.models import tacotron2 as t2
    cfg = t2.Tacotron2Config(symbol_embedding_dim=64,
                             encoder_embedding_dim=64, decoder_rnn_dim=128,
                             attention_rnn_dim=128, prenet_dim=32,
                             postnet_embedding_dim=64, prenet_dropout=0.0,
                             attention_dropout=0.0, decoder_dropout=0.0)
    base = t2.init_tacotron2(t2.Tacotron2(cfg), 0)
    g = torch.Generator().manual_seed(0)
    B, T_txt, T_mel = 3, 20, 96
    tokens = torch.randint(1, 40, (B, T_txt), generator=g)
    token_lens = torch.tensor([20, 13, 5])
    mel = torch.randn((B, T_mel, 80), generator=g) - 4.0
    mel_lens = torch.tensor([96, 70, 33])
    outs = {}
    with mock.patch.object(t2.Tacotron2, "_dropout",
                           lambda self, x, rate, gen: x):
        for dev in ("cpu", cuda):
            model = copy.deepcopy(base).to(dev).train()
            got = model.forward_train(tokens.to(dev), token_lens,
                                      mel.to(dev), mel_lens.to(dev))
            got[1].square().mean().backward()
            outs[str(dev)] = ([o.detach().cpu() for o in got],
                              {k: v.cpu() for k, v in
                               model.state_dict().items()},
                              model.embedding.weight.grad.cpu())
    (o_cpu, sd_cpu, g_cpu), (o_gpu, sd_gpu, g_gpu) = outs["cpu"], outs["cuda"]
    for a, b in zip(o_gpu, o_cpu):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for k, v in sd_cpu.items():
        if "running" in k:
            assert not torch.equal(v, base.state_dict()[k]), k
            torch.testing.assert_close(sd_gpu[k], v, rtol=0, atol=1e-5,
                                       msg=k)
    assert float((g_gpu - g_cpu).abs().max()) <= 1e-4 * float(
        g_cpu.abs().max())


# ---- vocoder training: gradients through the ResBlock1 kernel ----------------

def _training_generator(cuda, seed=1):
    """HiFi-GAN V1's kernels and dilations on 256 initial channels (stages
    128/64 wide, 32/16 narrow: widths the f32 kernels are built for)."""
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    return init_weights(Generator(HiFiGANConfig(
        upsample_initial_channel=256)), seed).to(cuda)


@pytest.mark.cuda
def test_generator_gradient_reaches_every_parameter_on_the_card(cuda):
    """A loss through the generator on the card gives every parameter a
    non-zero gradient (the kernel's result stays in the graph) through 18
    wide + 6 narrow kernel launches; all the gradients together within
    1e-4 of their norm of the same loss's in float64 on the CPU (plain
    ResBlocks). A single early tensor (conv_pre) is not compared alone:
    an f32 CPU run is itself 1.3e-4 of its norm from float64 there."""
    from unittest import mock

    from tts_arabic_torch.vocoder import hifigan
    gen = _training_generator(cuda)
    g = torch.Generator().manual_seed(0)
    mel = torch.randn((2, 12, 80), generator=g)
    r = torch.randn((2, 12 * 256), generator=g)
    before = dict(rb.LAUNCHES)
    ((gen(mel.to(cuda)) * r.to(cuda)).sum()).backward()
    torch.cuda.synchronize()
    assert rb.LAUNCHES["resblock1_wide"] - before["resblock1_wide"] == 18
    assert rb.LAUNCHES["resblock1_narrow"] - before[
        "resblock1_narrow"] == 6
    exact = _training_generator("cpu").double()
    with mock.patch.object(hifigan, "resblock1", rb.resblock1_plain):
        ((exact(mel.double()) * r.double()).sum()).backward()
    diff = norm = 0.0
    for (name, p), q in zip(gen.named_parameters(), exact.parameters()):
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        diff += float((p.grad.double().cpu() - q.grad).pow(2).sum())
        norm += float(q.grad.pow(2).sum())
    assert diff ** 0.5 <= 1e-4 * norm ** 0.5, (diff ** 0.5, norm ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("C", [256, 128, 64, 32])
def test_resblock1_function_gradients_on_the_card(cuda, C, k):
    """`ResBlock1Function` on the card (the f32 kernel forward, the plain
    recompute) against autograd through `resblock1_plain` on the card, TF32
    off, at each stage width of the training generator: the output equal
    to the kernel's, every gradient within 1e-5 of its norm."""
    T = 2 * 256 * 8 // (C // 32) + 5
    x, w1, b1, w2, b2 = _case(C, k, T, torch.float32)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)
                    ).to(cuda)
    outs = {}
    for label, fn in (("function", rb.ResBlock1Function.apply),
                      ("plain", rb.resblock1_plain)):
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        before = sum(rb.LAUNCHES.values())
        y = fn(*leaves, k, DIL)
        (y * r).sum().backward()
        torch.cuda.synchronize()
        outs[label] = (y.detach(), [t.grad for t in leaves],
                       sum(rb.LAUNCHES.values()) - before)
    (y_f, g_f, n_f), (y_p, g_p, n_p) = outs["function"], outs["plain"]
    assert n_f > 0 and n_p == 0
    with torch.no_grad():
        assert torch.equal(y_f, rb.resblock1(x, w1, b1, w2, b2, k, DIL))
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), g_f, g_p):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * float(b.norm()), (name, err)


@pytest.mark.cuda
def test_graded_and_no_grad_forwards_are_equal_and_follow_a_step(cuda):
    """The generator's no-grad forward (kept stacks, side streams) and its
    graded one (fresh stacks through the Function, one stream) give equal
    waves; after an optimizer step both read the new weights, as a fresh
    generator loaded with them does."""
    gen = _training_generator(cuda)
    mel = torch.randn((2, 16, 80), generator=torch.Generator().manual_seed(3)
                      ).to(cuda)
    opt = torch.optim.SGD(gen.parameters(), lr=1e-2)
    with torch.no_grad():
        first = gen(mel)
    graded = gen(mel)
    assert graded.grad_fn is not None
    assert torch.equal(graded.detach(), first)
    graded.square().mean().backward()
    opt.step()
    with torch.no_grad():
        after = gen(mel)
    again = gen(mel)
    fresh = _training_generator(cuda, seed=2)
    fresh.load_state_dict(gen.state_dict())
    with torch.no_grad():
        want = fresh(mel)
    assert not torch.equal(after, first)
    assert torch.equal(after, want)
    assert torch.equal(again.detach(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [256, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_resblock_op_launches_the_kernel(cuda, C, dtype):
    """`tts_arabic::resblock1` on CUDA tensors: opcheck, the same launches
    and the same bits as `resblock1`, weights in the kernel layout."""
    x, w1, b1, w2, b2 = _case(C, 7, 300, dtype, seed=3)
    args = (x, rb.kernel_weights(w1, dtype), b1, rb.kernel_weights(w2, dtype),
            b2, 7, list(DIL))
    torch.library.opcheck(torch.ops.tts_arabic.resblock1.default, args)
    rb.reset_launches()
    got = torch.ops.tts_arabic.resblock1(*args)
    launches = dict(rb.LAUNCHES)
    want = rb.resblock1(x, w1, b1, w2, b2, 7, DIL)
    torch.cuda.synchronize()
    assert launches == {rb.variant(C): 3 if C > 32 else 1,
                        ("resblock1_narrow" if C > 32 else
                         "resblock1_wide"): 0}
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bundle_exported_on_the_card_equals_the_live_path(cuda, tmp_path):
    """A narrow FastPitch bundle exported for the card: its wave program
    launches the kernels (27 wide + 3 narrow a call: the vocoder's stages
    of 256-32 channels) and its int16 waves equal the live path's."""
    import numpy as np

    from tts_arabic_torch.apps import export_serving as es
    from tts_arabic_torch.infer import FastPitch2Wave
    from tts_arabic_torch.infer.pipeline import _pick_mel_bucket
    from tts_arabic_torch.models.fastpitch import FastPitchConfig
    from tts_arabic_torch.runtime.checkpoint import save_states
    pipe = FastPitch2Wave(seed=0, arabic_in=False, device="cuda",
                          compute_dtype=torch.bfloat16,
                          config=FastPitchConfig(d_model=64, enc_n_layers=1,
                                                 dec_n_layers=1))
    with torch.no_grad():
        pipe.model.model.duration_predictor.fc.bias.add_(2.0)
    ckpt = tmp_path / "states.ckpt"
    save_states(ckpt, config={
        "net_config": pipe.model.config.to_reference_net_config()},
        model=pipe.model.model.state_dict())
    texts = ["kitAbun", "salAm wa kitAb"]
    want = pipe.tts(texts, batch_size=2, denoise=0.005, out_int16=True)
    frames = pipe.model.ttmel(texts, batch_size=2)
    bucket = _pick_mel_bucket(max(m.shape[1] for m in frames))
    out = es.export_bundle(tmp_path / "bundle", str(ckpt), batch_sizes=(2,),
                           text_buckets=(16,), mel_buckets=(bucket,))
    bundle = es.ServingBundle(out)
    assert bundle.manifest["device"] == "cuda"
    bundle.tts(texts)
    rb.reset_launches()
    got = bundle.tts(texts, denoise=0.005)
    assert dict(rb.LAUNCHES) == {"resblock1_wide": 27,
                                 "resblock1_narrow": 3}
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == w.shape
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 8


# the JAX package's gate-control test settings (tests/test_gate_control.py)
GATE_TEXTS = ["ذَهَبَ الوَلَدُ", "صِفر", "كِتاب جَدِيد", "شَمس"]
GATE_TARGETS = [120, 40, 90, 64]
GATE_MS = dict(
    n_symbols=40, symbol_embedding_dim=32, encoder_embedding_dim=32,
    num_speakers=8, speaker_embedding_dim=16, decoder_rnn_dim=48,
    attention_rnn_dim=48, attention_hidden_dim=16,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    prenet_dim=16, postnet_embedding_dim=32, postnet_n_convolutions=3,
    n_mels=80, decoder_max_step=160)


@pytest.mark.cuda
def test_gate_control_on_graphed_decodes(cuda, tmp_path, monkeypatch):
    """Calibrated on the card, on numpy-seeded weights at the JAX test's
    widths (the port's own seed-0 init has no stop to reach there: its
    gate logit peaks at step 0 in every row under each of the three
    dithers, on the CPU as on the card), with the batch's decode-block
    graph captured:
    the calibration's live decodes replay it (its no-early-stop probes
    may not), the graphed and the eager decode realize the calibrated
    lengths, tts() too, and a second install replays the cache."""
    from unittest import mock

    import numpy as np

    from tts_arabic_torch.eval import install_gate_control
    from tts_arabic_torch.eval.gate_control import decode_in_tts_order
    from tts_arabic_torch.infer import Tacotron2Wave
    from torch_port_weights import write_tacotron2_weights
    from tts_arabic_torch.models.tacotron2 import Tacotron2Config
    monkeypatch.setenv("TTS_ARABIC_TORCH_GATE_CACHE", str(tmp_path))
    pipe = Tacotron2Wave(write_tacotron2_weights(
        tmp_path, Tacotron2Config(**GATE_MS)), device="cuda")
    m = pipe.model
    m.decoder_max_step = 160
    n_ids = max(len(t) for t in m.tokenize_batch(list(GATE_TEXTS)))
    m.capture_graphs((4,), (-(-n_ids // 16) * 16,))
    kw = dict(postprocess_mel=False, dither_candidates=(0.0, 1.0, -1.0))
    speakers, lengths, report = install_gate_control(
        pipe, GATE_TEXTS, GATE_TARGETS, **kw)
    assert report["cache"] == "miss" and m.graph_replays > 0
    assert report["n_fired"] >= 3 and report["cap_fallback"] <= 1

    def decode():
        return decode_in_tts_order(m, GATE_TEXTS, speakers)[
            "mel_lens"].cpu().numpy()
    replays = m.graph_replays
    np.testing.assert_array_equal(decode(), lengths)
    assert m.graph_replays > replays
    with mock.patch.dict(m._graphs, clear=True):
        np.testing.assert_array_equal(decode(), lengths)
    waves = pipe.tts(list(GATE_TEXTS), speaker_id=speakers, batch_size=4,
                     denoise=0.0, postprocess_mel=False)
    assert [len(w) // pipe.hop_length for w in waves] == list(lengths)
    spk2, len2, rep2 = install_gate_control(pipe, GATE_TEXTS, GATE_TARGETS,
                                            **kw)
    assert rep2["cache"] == "hit"
    np.testing.assert_array_equal(spk2, speakers)
    np.testing.assert_array_equal(len2, lengths)


@pytest.mark.cuda
def test_parallel_layer_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one GPU;
    `torch_port_parallel_worker.run_cuda`): sp_vocode through the ResBlock
    kernels within 1e-5 of the peak (f32) and above 35.99 dB (bf16) of the
    one-process call, with one sharded pass of the kernels a rank; a DP
    FastPitch step with one MAS launch a rank, its loss terms within 1e-5
    of the one-process step."""
    import numpy as np

    import torch_port_parallel_worker as worker
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=worker.run_cuda,
                         args=(r, 2, str(tmp_path / "store"), queue),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    ranks = {}
    try:
        while len(ranks) < 2:
            rank, out = queue.get(timeout=600)
            assert not isinstance(out, str), f"rank {rank}:\n{out}"
            ranks[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    for r in range(2):
        for dtype in ("torch.float32", "torch.bfloat16"):
            got, full, launches = ranks[r][dtype]
            assert got.shape == full.shape
            assert launches["resblock1_wide"] > 0 or \
                launches["resblock1_narrow"] > 0, launches
            if dtype == "torch.float32":
                assert np.abs(got - full).max() <= 1e-5 * np.abs(full).max()
            else:
                snr = 10 * np.log10(np.mean(full ** 2)
                                    / np.mean((got - full) ** 2))
                assert snr > 35.99, snr
        assert ranks[r]["mas_launches"] == 1
        assert ranks[r]["dp"] == ranks[0]["dp"]
    for k, v in ranks[0]["single"].items():
        if k != "grad_norm":
            assert abs(ranks[0]["dp"][k] - v) <= 1e-5 * max(abs(v), 1e-12), k
