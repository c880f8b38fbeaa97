"""The port's Tacotron2 model against the JAX package's, on the CPU in f32:
seeded reference-layout weights (numpy draws, random BatchNorm running
statistics; `torch_port_weights.tacotron2_state_dict`) loaded into both,
JAX's SMALL widths with 3 speakers, prenet dropout off (the masks cannot
match JAX's bits). The decode tolerances are JAX's own oracle tolerances
(`tests/test_tacotron2.py`): mel and mel_postnet rtol 1e-3 / atol 2e-3,
alignments 1e-3, equal lengths."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_weights import SMALL_TACOTRON2, tacotron2_state_dict
from tts_arabic_torch.models import convert
from tts_arabic_torch.models import tacotron2 as port_t2
from tts_arabic_tpu.infer.pipeline import cast_floating
from tts_arabic_tpu.models import tacotron2 as jax_t2
from tts_arabic_tpu.models import torch_export
from tts_arabic_tpu.models.torch_import import tacotron2_params_from_torch

SMALL_MS = dict(SMALL_TACOTRON2, num_speakers=3, speaker_embedding_dim=8,
                prenet_dropout=0.0)
STEPS = 96
LENS = [16, 11, 7]
SPEAKERS = [2, 0, 1]
TOL = dict(rtol=1e-3, atol=2e-3)
GATE_SCALE = -100.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens():
    rng = np.random.default_rng(1)
    tok = rng.integers(1, 40, (len(LENS), max(LENS))).astype(np.int64)
    for b, L in enumerate(LENS):
        tok[b, L:] = 0
    return tok


class Pair:
    """The same weights in both packages, and JAX's infer jitted once (its
    weights are arguments, so a changed gate bias reuses the trace)."""

    def __init__(self):
        self.pc = port_t2.Tacotron2Config(**SMALL_MS)
        self.jc = jax_t2.Tacotron2Config(**SMALL_MS)
        self.sd = tacotron2_state_dict(self.pc, seed=0)
        self.port = port_t2.Tacotron2(self.pc).eval()
        self.port.load_state_dict(self.sd, strict=True)
        self.jax = jax_t2.Tacotron2(self.jc)
        self.tokens = _tokens()
        self._infer = jax.jit(lambda v, tok, lens, spk: self.jax.apply(
            v, tok, lens, spk, max_steps=STEPS, method=jax_t2.Tacotron2.infer))

    def jax_vars(self, dtype=None):
        v = tacotron2_params_from_torch(
            {k: val.numpy() for k, val in self.sd.items()}, self.jc)
        return v if dtype is None else cast_floating(v, dtype)

    def set_gate(self, bias, weight_scale=1.0):
        self.sd["decoder.gate_layer.linear_layer.weight"].mul_(weight_scale)
        self.sd["decoder.gate_layer.linear_layer.bias"].fill_(bias)
        self.port.load_state_dict(self.sd, strict=True)

    def ragged(self):
        """Rows that stop at distinct steps before the cap: an uncapped
        decode's gate logits are recorded, and the gate is set from them.
        The random decode settles, its logits falling, so the gate weight
        is scaled by GATE_SCALE (negative), which makes each row's logit
        rise as it settles; then the bias is chosen from the recorded
        logits so scaled (the gate does not feed back into the recurrence,
        so the trajectories stay the same). Returns the stop steps."""
        self.set_gate(-100.0)
        logits = GATE_SCALE * (self.jax_infer()["gates"] + 100.0)
        bias, stops = _ragged_gate_bias(logits, STEPS)
        self.set_gate(bias, GATE_SCALE)
        return stops

    def jax_infer(self, dtype=None):
        out = self._infer(self.jax_vars(dtype), jnp.asarray(self.tokens,
                                                            jnp.int32),
                          jnp.asarray(LENS, jnp.int32),
                          jnp.asarray(SPEAKERS, jnp.int32))
        return {k: np.asarray(v, np.float32) if v.dtype != jnp.int32
                else np.asarray(v) for k, v in jax.device_get(out).items()}

    def port_infer(self, dtype=torch.float32, **kw):
        with torch.no_grad():
            out = self.port.infer(torch.from_numpy(self.tokens),
                                  torch.tensor(LENS), torch.tensor(SPEAKERS),
                                  max_steps=STEPS, dtype=dtype, **kw)
        return {k: v.float().numpy() if v.is_floating_point() else v.numpy()
                for k, v in out.items()}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _assert_decode_matches(got, want):
    np.testing.assert_array_equal(got["mel_lens"], want["mel_lens"])
    np.testing.assert_allclose(got["mel"], want["mel"], **TOL)
    np.testing.assert_allclose(got["mel_postnet"], want["mel_postnet"], **TOL)
    np.testing.assert_allclose(got["alignments"], want["alignments"],
                               atol=1e-3)
    for b, L in enumerate(got["mel_lens"]):
        assert not got["mel"][b, L:].any()
        assert not got["alignments"][b, L:].any()


def test_converter_matches_jax_exporter(pair):
    """The port's `tacotron2_params_to_torch` equals the JAX exporter's
    state dict (BatchNorm running statistics included) and loads strict."""
    variables = pair.jax_vars()
    got = convert.tacotron2_params_to_torch(variables, pair.jc)
    want = torch_export.tacotron2_params_to_torch(variables, pair.jc)
    assert got.keys() == want.keys() == pair.sd.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got[key], pair.sd[key].numpy(),
                                      err_msg=key)
    port_t2.Tacotron2(pair.pc).load_state_dict(convert.to_tensors(got),
                                               strict=True)


def test_encode_ragged_and_pad_invariant(pair):
    tok = torch.from_numpy(pair.tokens)
    with torch.no_grad():
        mem = pair.port.encode(tok, torch.tensor(LENS),
                               torch.tensor(SPEAKERS)).numpy()
        wide = pair.port.encode(torch.nn.functional.pad(tok, (0, 9)),
                                torch.tensor(LENS),
                                torch.tensor(SPEAKERS)).numpy()
    want = np.asarray(pair.jax.apply(
        pair.jax_vars(), jnp.asarray(pair.tokens, jnp.int32),
        jnp.asarray(LENS, jnp.int32), jnp.asarray(SPEAKERS, jnp.int32),
        method=jax_t2.Tacotron2.encode))
    assert mem.shape == want.shape == (3, 16, 40)
    for b, L in enumerate(LENS):
        np.testing.assert_allclose(mem[b, :L], want[b, :L], atol=1e-5)
        np.testing.assert_allclose(wide[b, :L], mem[b, :L], atol=1e-6)


def test_postnet_matches_jax(pair):
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, 21, 80)).astype(np.float32)
    lens = np.array([21, 13])
    with torch.no_grad():
        got = pair.port.postnet(torch.from_numpy(mel),
                                torch.from_numpy(lens)).numpy()
    want = np.asarray(pair.jax.apply(
        pair.jax_vars(), jnp.asarray(mel), jnp.asarray(lens),
        method=jax_t2.Tacotron2.postnet))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_teacher_forced_forward_matches_jax(pair):
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((3, 12, 80)).astype(np.float32)
    mel_lens = np.array([12, 9, 5])
    with torch.no_grad():
        got = pair.port(torch.from_numpy(pair.tokens), torch.tensor(LENS),
                        torch.from_numpy(mel), torch.from_numpy(mel_lens),
                        torch.tensor(SPEAKERS))
    want = pair.jax.apply(
        pair.jax_vars(), jnp.asarray(pair.tokens, jnp.int32),
        jnp.asarray(LENS, jnp.int32), jnp.asarray(mel),
        jnp.asarray(mel_lens), jnp.asarray(SPEAKERS, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_infer_matches_jax_at_the_cap(pair):
    got, want = pair.port_infer(), pair.jax_infer()
    assert list(got["mel_lens"]) == [STEPS] * 3
    _assert_decode_matches(got, want)
    np.testing.assert_allclose(got["gates"], want["gates"], atol=1e-4)


def _ragged_gate_bias(logits: np.ndarray, cap: int) -> tuple:
    """A gate bias under which the rows of an uncapped decode (its recorded
    gate logits at bias 0, [B, S]) stop at distinct steps before `cap`,
    each crossing at least 1e-3 away from the threshold (the most distinct
    stops, then the latest first stop, then the latest last one)."""
    best = None
    values = np.unique(np.round(logits, 4))
    for theta in (values[1:] + values[:-1]) / 2:
        stops = []
        for row in logits:
            hit = np.flatnonzero(row > theta)
            stops.append(int(hit[0]) if hit.size else cap)
        margin = min(np.abs(row[: s + 1] - theta).min()
                     for row, s in zip(logits, stops))
        if max(stops) < cap - 8 and margin > 1e-3:
            score = (len(set(stops)), min(stops), max(stops))
            if best is None or score > best[0]:
                best = (score, -float(theta), stops)
    assert best is not None and best[0][0] >= 2, best
    return best[1], best[2]


def test_infer_ragged_stops_match_jax():
    """Rows stop at different steps before the cap (the gate set from one
    uncapped JAX decode's recorded logits, `Pair.ragged`)."""
    pair = Pair()
    stops = pair.ragged()
    got, want = pair.port_infer(), pair.jax_infer()
    lens = list(got["mel_lens"])
    assert lens == [s + 1 for s in stops] and len(set(lens)) >= 2
    assert max(lens) < STEPS
    _assert_decode_matches(got, want)
    # the loop stopped with the last row: nothing was written past it
    assert not got["gates"][:, max(lens):].any()


@pytest.mark.parametrize("block", [1, 7, 16])
def test_predicated_blocks_leave_the_jax_outputs(pair, block, monkeypatch):
    """Any block size gives the same outputs: the steps a block runs past
    the exit write nothing."""
    monkeypatch.setattr(port_t2, "DECODE_BLOCK", block)
    ref = pair.port_infer()
    blocks = []
    run = port_t2.Tacotron2.run_segment

    def counted(self, *a, **kw):
        blocks.append(run(self, *a, **kw))
    monkeypatch.setattr(port_t2.Tacotron2, "run_segment", counted)
    got = pair.port_infer()
    assert blocks == [-(-STEPS // block)]
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_decode_segments_concatenate_to_infer():
    pair = Pair()
    pair.ragged()
    want = pair.port_infer()
    m = pair.port
    with torch.no_grad():
        enc = m.encode_infer(torch.from_numpy(pair.tokens),
                             torch.tensor(LENS), torch.tensor(SPEAKERS))
        carry = m.init_decode_carry(enc["memory"])
        mels, aligns, n_total = [], [], 0
        for n_steps in (13, 32, 32, 32):
            carry, seg = m.decode_segment(carry, enc, None, n_steps=n_steps)
            n_new = int(seg["n_new"])
            assert seg["mel"].shape == (3, n_steps, 80)
            assert not seg["mel"][:, n_new:].any()
            mels.append(seg["mel"][:, :n_new])
            aligns.append(seg["align"][:, :n_new])
            n_total += n_new
            if n_new < n_steps:
                break
    assert n_total == max(want["mel_lens"]) < STEPS
    np.testing.assert_array_equal(carry["lengths"].numpy(), want["mel_lens"])
    np.testing.assert_array_equal(torch.cat(mels, 1).numpy(),
                                  want["mel"][:, :n_total])
    np.testing.assert_array_equal(torch.cat(aligns, 1).numpy(),
                                  want["alignments"][:, :n_total])


def test_bf16_decode_against_jax_bf16(pair):
    """compute dtype bf16 on both sides (the weights cast, JAX's
    `cast_floating`): equal lengths, mel within 2% rel-RMSE of JAX's bf16
    decode (0.47% when written; JAX's own bf16 decode is 0.49% from its
    f32 one: both round every step to bf16, along different op orders)."""
    got = pair.port_infer(dtype=torch.bfloat16)
    want = pair.jax_infer(jnp.bfloat16)
    np.testing.assert_array_equal(got["mel_lens"], want["mel_lens"])
    err = np.sqrt(np.mean((got["mel"] - want["mel"]) ** 2))
    assert err / np.sqrt(np.mean(want["mel"] ** 2)) < 0.02


def test_prenet_dropout_masks():
    """Drawn up front from an explicit generator: the same seed gives the
    same masks, the default is seed 0, and the kept share is 1 - 0.5."""
    model = port_t2.Tacotron2(port_t2.Tacotron2Config(
        **dict(SMALL_MS, prenet_dropout=0.5)))
    draw = lambda seed: model.prenet_masks(  # noqa: E731
        999, 4, "cpu", torch.Generator().manual_seed(seed))
    masks = draw(0)
    assert masks.shape == (1000, 2, 4, 16) and masks.dtype == torch.bool
    assert torch.equal(masks, draw(0))
    assert torch.equal(masks, model.prenet_masks(999, 4, "cpu"))
    assert not torch.equal(masks, draw(1))
    assert abs(float(masks.float().mean()) - 0.5) < 0.02
    assert dataclasses.replace(model.config, prenet_dropout=0.0)
