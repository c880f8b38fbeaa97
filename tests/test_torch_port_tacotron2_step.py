"""The fused Tacotron2 decode step (`ops.tacotron2_step`,
`csrc/tacotron2_step.cu`): its routing, its op and its counts on the CPU,
and its kernels against the plain step on the card.

Imports no JAX. The `cuda` tests skip without a card; on one:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_tacotron2_step.py
"""
import contextlib
import ctypes
import dataclasses
import pathlib
import re
from unittest import mock

import numpy as np
import pytest
import torch

from tts_arabic_torch.models import tacotron2 as t2
from tts_arabic_torch.ops import build
from tts_arabic_torch.ops import tacotron2_step as fused
from tts_arabic_torch.runtime import profiling

SMALL = dict(n_symbols=40, symbol_embedding_dim=32, encoder_embedding_dim=32,
             num_speakers=3, speaker_embedding_dim=8, decoder_rnn_dim=48,
             attention_rnn_dim=48, attention_hidden_dim=16,
             attention_location_n_filters=4,
             attention_location_kernel_size=7, prenet_dim=16,
             postnet_embedding_dim=32, postnet_n_convolutions=3, n_mels=80,
             decoder_max_step=40)
# the benchmark's Tacotron2 (port_bench/configs/tacotron2-gate-hifigan-v1)
FULL = dict(num_speakers=40, decoder_max_step=3000)


def _model(cfg: dict, seed: int = 0, gate_bias: float = -3.0,
           device="cpu") -> t2.Tacotron2:
    model = t2.init_tacotron2(t2.Tacotron2(t2.Tacotron2Config(**cfg)), seed)
    with torch.no_grad():
        model.decoder.gate_layer.linear_layer.bias.fill_(gate_bias)
    return model.eval().to(device)


def _enc(model, B: int, T: int, dtype=torch.float32, seed: int = 0):
    """The encoder's outputs of B seeded rows of lengths spread up to T."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(T - 3 * np.arange(B), 1)
    tok = rng.integers(1, model.config.n_symbols, (B, T))
    tok[np.arange(T)[None, :] >= lens[:, None]] = 0
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model.encode_infer(
            torch.from_numpy(tok).to(dev), torch.from_numpy(lens).to(dev),
            torch.arange(B, device=dev) % max(model.config.num_speakers, 1),
            dtype=dtype)


def _start(model, enc, n_steps: int, limit: int, seed: int = 0):
    B = enc["memory"].shape[0]
    dev = enc["memory"].device
    carry = model.init_decode_carry(enc["memory"])
    bufs = model.decode_buffers(enc["memory"], n_steps)
    masks = model.prenet_masks(
        n_steps, B, dev, torch.Generator(dev).manual_seed(seed))
    lim = torch.full((1,), limit, dtype=torch.long, device=dev)
    model.start_segment(carry, lim)
    return carry, bufs, masks, lim


def _plain_block(model, carry, enc, bufs, masks, limit):
    """The block as it was: DECODE_BLOCK of `_predicated_step`, copied
    back."""
    w = model.decoder_weights(enc["memory"].dtype)
    c = dict(carry)
    for _ in range(t2.DECODE_BLOCK):
        c = model._predicated_step(c, enc, bufs, w, masks, limit)
    for key, val in carry.items():
        val.copy_(c[key])


def _clone(d):
    return {k: v.clone() for k, v in d.items()}


# ---- the CPU: routing, the op, the counts ------------------------------------

@pytest.mark.parametrize("early", [True, False], ids=["early", "no_early"])
@pytest.mark.parametrize("B", [1, 3])
def test_decode_block_equals_the_plain_loop_on_the_cpu(B, early):
    """decode_block (through `ops.tacotron2_step.decode_steps`) is bit-equal
    to the plain `_predicated_step` loop on the CPU, over three blocks with
    the segment's limit inside the second, and a gate that stops a row."""
    cfg = dict(SMALL, decoder_early_stopping=early)
    model = _model(cfg, gate_bias=0.0)
    enc = _enc(model, B, 12)
    a = _start(model, enc, 40, limit=21)
    b = tuple(_clone(x) if isinstance(x, dict) else x.clone() for x in a)
    with torch.no_grad():
        for _ in range(3):
            model.decode_block(a[0], enc, a[1], a[2], a[3])
            _plain_block(model, b[0], enc, b[1], b[2], b[3])
    for got, want in ((a[0], b[0]), (a[1], b[1])):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert int(a[0]["s"]) <= 21 and not bool(a[0]["go"])


def _cuda_mock(carry, err: int = 0):
    """A library whose `tacotron2_step` drops the run flag (as a decode that
    stops), counts its kernels' runs as the card would (a step's five, the
    block's preparation) and returns `err`; pointers matched to the carry's
    tensors. Its `tacotron2_step_runs` writes the counts to the (host)
    address it is given."""
    go_ptr = carry["go"].data_ptr()
    runs = [0] * len(fused.RUNS)

    def step(dtype, ptrs, dims, scalars, steps, stream):
        if not err:
            assert ptrs[fused._PTRS.index("go")] == go_ptr
            carry["go"].zero_()
            for i in range(fused.KERNELS_PER_STEP):
                runs[i] += steps
            runs[fused.RUNS.index("att_prep")] += 1
        return err

    def read(device, dst, stream):
        (ctypes.c_int64 * len(runs)).from_address(dst)[:] = runs
        return 0
    lib = mock.MagicMock()
    lib.tacotron2_step.side_effect = step
    lib.tacotron2_step_runs.side_effect = read
    return lib


@contextlib.contextmanager
def _on_a_mock_card(lib):
    with mock.patch.object(fused, "_on_card", lambda t: True), \
            mock.patch.object(fused, "_stream", lambda dev: 0), \
            mock.patch.object(fused, "_device_index", lambda dev: 0), \
            mock.patch.object(build, "library", lambda: lib):
        yield


def test_a_card_call_launches_the_op_and_never_falls_back():
    """With the CUDA library mocked, decode_block on 'card' tensors makes
    one C call of DECODE_BLOCK steps and bumps the launch counter: eagerly
    straight to the kernels, while `torch.export` traces through the op
    (whose body launches the same); the card's run counts read back. A
    failed launch, or a library that cannot be built, raises and leaves the
    carry as it was (no plain step behind it)."""
    model = _model(SMALL)
    enc = _enc(model, 2, 8)
    op = torch.ops.tts_arabic.tacotron2_step.default
    before = fused.LAUNCHES["tacotron2_step"]
    for exporting in (False, True):
        carry, bufs, masks, limit = _start(model, enc, 40, limit=40)
        lib = _cuda_mock(carry)
        with _on_a_mock_card(lib), mock.patch.object(
                torch.compiler, "is_exporting", lambda: exporting), \
                mock.patch.object(fused, "tacotron2_step_op",
                                  wraps=fused.tacotron2_step_op) as spy:
            runs = fused.device_runs(enc["memory"])
            model.decode_block(carry, enc, bufs, masks, limit)
            assert fused.steps_since(runs) == t2.DECODE_BLOCK
            assert fused.device_runs(enc["memory"]).tolist() == [
                t2.DECODE_BLOCK] * fused.KERNELS_PER_STEP + [1, 0]
        assert spy.call_count == int(exporting)
        assert lib.tacotron2_step.call_count == 1
        dtype, ptrs, dims, scalars, steps, stream = \
            lib.tacotron2_step.call_args.args
        assert (dtype, steps, list(dims)[:3]) == (0, t2.DECODE_BLOCK,
                                                  [2, 8, 80])
    assert fused.LAUNCHES["tacotron2_step"] == before + 2 * t2.DECODE_BLOCK
    assert op.name() == "tts_arabic::tacotron2_step"
    before = fused.LAUNCHES["tacotron2_step"]

    carry, bufs, masks, limit = _start(model, enc, 40, limit=40)
    kept = _clone(carry)
    with _on_a_mock_card(_cuda_mock(carry, err=9)), \
            pytest.raises(RuntimeError, match="cudaError 9"):
        model.decode_block(carry, enc, bufs, masks, limit)

    def unbuildable():
        raise RuntimeError("nvcc not found")
    with mock.patch.object(fused, "_on_card", lambda t: True), \
            mock.patch.object(build, "library", unbuildable), \
            pytest.raises(RuntimeError, match="nvcc"):
        model.decode_block(carry, enc, bufs, masks, limit)
    for key in kept:
        assert torch.equal(carry[key], kept[key]), key
    assert fused.LAUNCHES["tacotron2_step"] == before


def test_fused_steps_are_counted_only_while_recording():
    """`infer`'s tts.decode span counts fused_steps (the steps the kernels
    ran: all of them on a mocked card, none on the CPU) beside
    decode_steps, and only while spans are recorded."""
    model = _model(SMALL)
    tok = torch.randint(1, 40, (2, 8), generator=torch.Generator()
                        .manual_seed(0))

    def decode_span(card: bool):
        profiling.clear()
        real = model.init_decode_carry

        def init(memory):
            carry = real(memory)
            stack.enter_context(_on_a_mock_card(_cuda_mock(carry)))
            return carry
        with contextlib.ExitStack() as stack:
            if card:
                stack.enter_context(mock.patch.object(
                    model, "init_decode_carry", init))
            with torch.no_grad():
                model.infer(tok, max_steps=40)
        return [s for s in profiling.recorded() if s.name == "tts.decode"]

    assert decode_span(card=False) == [] and decode_span(card=True) == []
    with profiling.recording():
        plain, = decode_span(card=False)
        card, = decode_span(card=True)
    profiling.clear()
    assert plain.counts["fused_steps"] == 0 and plain.counts["decode_steps"]
    assert card.counts["fused_steps"] == card.counts["decode_steps"] == \
        t2.DECODE_BLOCK


def _op_args(model, enc, carry, bufs, masks, limit, steps=3):
    c = model.config
    w = fused.flat_weights(model.decoder_weights(enc["memory"].dtype))
    return (*(carry[k] for k in fused.CARRY), *(enc[k] for k in fused.ENC),
            *(bufs[k] for k in fused.BUFS), *w.values(), masks, limit, steps,
            c.prenet_dropout, c.gate_threshold, c.decoder_early_stopping)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_the_op_passes_opcheck_and_its_cpu_body_is_the_plain_step(dtype):
    """The op's schema (what it mutates), fake kernel and dispatch
    (opcheck); its CPU body equals the plain `_predicated_step` loop bit
    for bit; a tensor it does not take raises."""
    model = _model(SMALL, gate_bias=0.0)
    enc = _enc(model, 3, 10, dtype)
    carry, bufs, masks, limit = _start(model, enc, 12, limit=12)
    args = _op_args(model, enc, carry, bufs, masks, limit)
    torch.library.opcheck(torch.ops.tts_arabic.tacotron2_step.default,
                          tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args))
    want_c, want_b = _clone(carry), _clone(bufs)
    fused._plain_steps(model, want_c, enc, want_b,
                       model.decoder_weights(dtype), masks, limit, 3)
    torch.ops.tts_arabic.tacotron2_step(*args)
    for got, want in ((carry, want_c), (bufs, want_b)):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert int(carry["t"]) == 3
    bad = list(args)
    bad[fused.CARRY.index("lengths")] = carry["lengths"].long()
    with pytest.raises(ValueError, match="lengths must be"):
        torch.ops.tts_arabic.tacotron2_step(*bad)


def test_pointer_table_matches_the_kernels_enum():
    """The wrapper's pointer order (`_PTRS`, then the scratch) is the C
    source's `enum Ptr`, name for name."""
    src = (pathlib.Path(fused.__file__).parent.parent / "csrc"
           / "tacotron2_step.cu").read_text()
    body = re.search(r"enum Ptr \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "N_PTRS"
    py = [f"P_{k.upper()}" for k in fused._PTRS] + [
        f"P_S_{k.upper()}" for k in fused._SCRATCH] + [
        "P_S_GATE", "P_S_ATT_WEIGHTS", "P_TICKET"]
    assert py == names[:-1]


def test_run_counts_match_the_kernels_enum():
    """The wrapper's names of the card's run counts (`RUNS`) are the C
    source's `enum Run`, in order, the step's kernels first."""
    src = (pathlib.Path(fused.__file__).parent.parent / "csrc"
           / "tacotron2_step.cu").read_text()
    body = re.search(r"enum Run \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names == [f"R_{k.upper()}" for k in fused.RUNS] + ["N_RUNS"]
    assert len(fused.RUNS) == fused.KERNELS_PER_STEP + 2


# ---- the card: kernels against the plain step ----------------------------------

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


BLOCKS = 3
# mel frames and alignment rows, max |kernel - plain| / max |plain| over the
# three blocks: f32 differs by summation order only (1e-6 a step, grown
# through 48 recurrent steps); bf16 rounds the LSTM gates, the context and
# the projections at other places than ATen's ops (a bf16 unit is 2^-8 of a
# value, and the recurrence carries it on). The kernels read at most 5.9e-3
# in bf16; the location term dropped from the attention reads 0.13
TOL = {torch.float32: 1e-4, torch.bfloat16: 0.02}


def _gate_from_logits(model, enc, dtype):
    """Sets the gate so that rows stop at distinct steps inside the blocks:
    the plain decode's logits (gate bias 0, early stopping off: the states
    do not depend on the gate) and a threshold between two of them, of
    either sign, as far as possible from every logit up to each row's stop,
    so that both paths stop the rows alike."""
    n = BLOCKS * t2.DECODE_BLOCK
    gate = model.decoder.gate_layer.linear_layer
    cfg = model.config
    with torch.no_grad():
        gate.bias.zero_()
    model.config = dataclasses.replace(cfg, decoder_early_stopping=False)
    try:
        carry, bufs, masks, limit = _start(model, enc, n, limit=n)
        with torch.no_grad():
            fused._plain_steps(model, carry, enc, bufs,
                               model.decoder_weights(dtype), masks, limit, n)
    finally:
        model.config = cfg
    z = bufs["gate"][:, :n].float().cpu().numpy()
    best = None
    for sign in (1.0, -1.0):
        zs = sign * z
        for theta in np.unique(np.round(zs[:, 4:], 3)):
            stops = [int(np.flatnonzero(r > theta)[0]) if (r > theta).any()
                     else n for r in zs]
            if max(stops) >= n - 2 or len(set(stops)) < min(2, len(zs)):
                continue
            margin = min(np.abs(r[: s + 1] - theta).min()
                         for r, s in zip(zs, stops))
            if best is None or margin > best[0]:
                best = (margin, sign, theta, stops)
    assert best is not None, "no threshold stops the rows inside the blocks"
    _, sign, theta, _ = best
    with torch.no_grad():
        gate.weight.mul_(sign)
        gate.bias.fill_(-float(theta))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dtype", [
    (16, 240, torch.bfloat16), (1, 16, torch.bfloat16),
    (2, 32, torch.float32)], ids=["b16_t240_bf16", "b1_t16_bf16",
                                  "b2_t32_f32"])
def test_kernels_match_the_plain_block(cuda, B, T, dtype):
    """Three blocks of the fused step against three of the plain step at
    full width (the benchmark's configuration), from the same carry, with
    the gate set from the plain decode's logits so that rows stop ragged
    inside the blocks: equal lengths, finished, t, s and go; mel and
    alignment rows within TOL; the kernels launched DECODE_BLOCK steps a
    block; and a block after the run flag dropped writes nothing."""
    model = _model(FULL, device=cuda)
    enc = _enc(model, B, T, dtype)
    _gate_from_logits(model, enc, dtype)
    n = BLOCKS * t2.DECODE_BLOCK
    a = _start(model, enc, n, limit=n)
    b = tuple(_clone(x) if isinstance(x, dict) else x.clone() for x in a)
    before = fused.LAUNCHES["tacotron2_step"]
    runs = fused.device_runs(enc["memory"])
    with torch.no_grad():
        for _ in range(BLOCKS):
            model.decode_block(a[0], enc, a[1], a[2], a[3])
            _plain_block(model, b[0], enc, b[1], b[2], b[3])
    torch.cuda.synchronize()
    assert fused.LAUNCHES["tacotron2_step"] - before == n
    # on the card: each of the step's kernels ran once a step, the block's
    # preparation once a block, the bf16 pack once a block
    ran = (fused.device_runs(enc["memory"]) - runs).tolist()
    assert ran == [n] * fused.KERNELS_PER_STEP + [
        BLOCKS, BLOCKS if dtype == torch.bfloat16 else 0], ran
    for key in ("lengths", "finished", "t", "s", "go"):
        assert torch.equal(a[0][key], b[0][key]), (key, a[0][key], b[0][key])
    lengths = a[0]["lengths"].tolist()
    assert min(lengths) < n and len(set(lengths)) >= min(2, B), lengths
    for key in ("mel", "align"):
        got, want = a[1][key].float(), b[1][key].float()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= TOL[dtype], (key, err)
    # the flag is down: one more block leaves everything as it is
    if not bool(a[0]["go"]):
        kept_c, kept_b = _clone(a[0]), _clone(a[1])
        with torch.no_grad():
            model.decode_block(a[0], enc, a[1], a[2], a[3])
        for got, want in ((a[0], kept_c), (a[1], kept_b)):
            for key in want:
                assert torch.equal(got[key], want[key]), key


# one step from a shared carry (24 plain steps in), max |kernel - plain| /
# max |plain| of every carried value and of the step's mel, gate and
# alignment rows: f32 differs by summation order only (1.7e-7); bf16 by
# where the two round (the plain step rounds the LSTM gates and each of the
# cell's ops to bf16, the kernels keep them in f32 until h and c): at most
# 1.5 units of 2^-8 (5.9e-3), against 3.4 (0.013) with the input gate's
# bias dropped from the tensor-core LSTM
STEP_TOL = {torch.float32: 1e-6, torch.bfloat16: 0.009}
SHARED = 24


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dtype", [
    (16, 240, torch.bfloat16), (1, 16, torch.bfloat16),
    (2, 32, torch.float32)], ids=["b16_t240_bf16", "b1_t16_bf16",
                                  "b2_t32_f32"])
def test_one_step_from_a_shared_carry(cuda, B, T, dtype):
    """One fused step against one plain step from the same carry, where
    the recurrence cannot carry a difference on: equal books, and every
    carried value and the step's buffer rows within STEP_TOL."""
    model = _model(FULL, device=cuda)
    enc = _enc(model, B, T, dtype)
    carry, bufs, masks, limit = _start(model, enc, 2 * SHARED, 2 * SHARED)
    w = model.decoder_weights(dtype)
    with torch.no_grad():
        fused._plain_steps(model, carry, enc, bufs, w, masks, limit, SHARED)
        want_c, want_b = _clone(carry), _clone(bufs)
        fused.decode_steps(model, carry, enc, bufs, masks, limit, 1)
        fused._plain_steps(model, want_c, enc, want_b, w, masks, limit, 1)
    torch.cuda.synchronize()
    for key in fused.BOOKS:
        assert torch.equal(carry[key], want_c[key]), key
    got = {**{k: carry[k] for k in fused.STATE},
           **{k: bufs[k][:, SHARED] for k in fused.BUFS}}
    want = {**{k: want_c[k] for k in fused.STATE},
            **{k: want_b[k][:, SHARED] for k in fused.BUFS}}
    errs = {k: float((got[k].float() - want[k].float()).abs().max()
                     / want[k].float().abs().max()) for k in want}
    assert max(errs.values()) <= STEP_TOL[dtype], errs


@pytest.mark.cuda
def test_no_writes_while_the_flag_is_down(cuda):
    """A block started with go false writes nothing at all: the carry and
    the buffers keep their bits (every kernel returns on the flag)."""
    model = _model(FULL, device=cuda)
    enc = _enc(model, 4, 48, torch.bfloat16)
    carry, bufs, masks, limit = _start(model, enc, 32, limit=32)
    for x in list(carry.values()) + list(bufs.values()):
        if x.dtype.is_floating_point:
            x.normal_()
    carry["go"].zero_()
    kept_c, kept_b = _clone(carry), _clone(bufs)
    with torch.no_grad():
        model.decode_block(carry, enc, bufs, masks, limit)
    torch.cuda.synchronize()
    for got, want in ((carry, kept_c), (bufs, kept_b)):
        for key in want:
            assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
def test_a_weight_changed_in_place_reaches_the_next_replay(cuda):
    """One block captured as a CUDA graph, replayed; a parameter changed in
    place (`copy_`, as gate control does); the second replay from the same
    carry reads the new weight: it equals an eager block on the new
    weights and differs from the first replay."""
    model = _model(FULL, device=cuda)
    enc = _enc(model, 16, 240, torch.bfloat16)
    carry, bufs, masks, limit = _start(model, enc, 32, limit=32)
    c0, b0 = _clone(carry), _clone(bufs)

    def block():
        model.decode_block(carry, enc, bufs, masks, limit)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        block()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        block()

    def replay():
        for src, dst in ((c0, carry), (b0, bufs)):
            for key in src:
                dst[key].copy_(src[key])
        graph.replay()
        torch.cuda.synchronize()
        return bufs["mel"].clone()
    runs = fused.device_runs(enc["memory"])
    launched = fused.LAUNCHES["tacotron2_step"]
    first = replay()
    # a replay launches nothing from the host, and the card counts its steps
    assert fused.LAUNCHES["tacotron2_step"] == launched
    assert fused.steps_since(runs) == t2.DECODE_BLOCK
    w = model.decoder.decoder_rnn.weight_hh
    with torch.no_grad():
        w.copy_(w * 1.5)
    second = replay()
    for src, dst in ((c0, carry), (b0, bufs)):
        for key in src:
            dst[key].copy_(src[key])
    with torch.no_grad():
        block()
    torch.cuda.synchronize()
    assert torch.equal(second, bufs["mel"])
    assert not torch.equal(first, second)


@pytest.mark.cuda
def test_packed_weights_equal_decoder_weights(cuda):
    """The one-launch bf16 pack gives `decoder_weights`' tensors bit for
    bit, each in its shape."""
    model = _model(FULL, device=cuda)
    got = fused.flat_weights(fused.packed_weights(model, torch.bfloat16))
    want = fused.flat_weights(model.decoder_weights(torch.bfloat16))
    torch.cuda.synchronize()
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
