"""The arithmetic of the f32 ResBlock1 kernels (3xTF32 on the tensor
cores), modelled on the CPU, where the kernels cannot run.

- A numpy model of `cvt.rna.tf32.f32`, checked bit for bit on edge values
  (ties, carries into the exponent, subnormals, signed zeros, the largest
  magnitudes) and held bit for bit to the port's `ops.resblock.tf32_split`
  on a CPU tensor. `tests/test_torch_port_cuda.py` holds the kernels' own
  split on the card to the same plain version.
- A model of the kernels' ResBlock1: each operand split into a big and a
  small TF32 part, three products a term in the kernels' order (big*small,
  small*big, big*big) accumulated in f32 in K steps of 8, held against the
  JAX package's ResBlock1 (`_resblock_xla` and the flax module) and a
  float64 evaluation, on numpy-seeded inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.ops import resblock as port_rb
from tts_arabic_tpu.ops.hifigan_pallas import _resblock_xla
from tts_arabic_tpu.vocoder.hifigan import ResBlock1

DIL = (1, 3, 5)
SLOPE = 0.1
# the model against the JAX package and float64: max |diff| / max |ref|.
# The model reads 1.3e-7 to 4.3e-7 here (one TF32 product a term: 2.5e-4
# to 4e-4); 2e-6 is about five times the largest reading and fifty times
# inside the 1e-4 the card holds the kernels to
MODEL_TOL = 2e-6


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, to nearest with
    ties away from zero, the low 13 bits of the word zero; infinities and
    NaN pass."""
    a = np.asarray(a, np.float32)
    bits = a.view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    return np.where(np.isfinite(a), out, a)


def split(a: np.ndarray):
    big = tf32_rna(a)
    with np.errstate(invalid="ignore"):     # inf - inf past the largest
        return big, tf32_rna(a - big)


def _f32(*words: int) -> np.ndarray:
    return np.array(words, np.uint32).view(np.float32)


# (input word, cvt.rna.tf32.f32's word)
EDGES = [
    (0x3F800000, 0x3F800000),   # 1.0 is a TF32 value
    (0x3F801000, 0x3F802000),   # a tie: away from zero (even would be down)
    (0x3F800FFF, 0x3F800000),   # just under a tie
    (0x3F801001, 0x3F802000),   # just over
    (0xBF801000, 0xBF802000),   # a negative tie, away from zero
    (0x3F803000, 0x3F804000),   # a tie above an odd TF32 value
    (0x3FFFF000, 0x40000000),   # a tie that carries into the exponent: 2.0
    (0xBFFFFFFF, 0xC0000000),   # a carry, negative
    (0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000),   # -0
    (0x00000001, 0x00000000),   # the smallest subnormal rounds to 0
    (0x80000FFF, 0x80000000),   # to -0
    (0x00001000, 0x00002000),   # a subnormal tie
    (0x00345678, 0x00346000),   # a subnormal
    (0x007FF000, 0x00800000),   # a subnormal carrying into the normals
    (0x7F7FEFFF, 0x7F7FE000),   # near the largest finite value
    (0x7F7FFFFF, 0x7F800000),   # the largest: rounds up past it, to inf
    (0xFF7FF000, 0xFF800000),   # a negative tie there: -inf
    (0x7F800000, 0x7F800000),   # inf
    (0xFF800000, 0xFF800000),   # -inf
]


def test_tf32_rna_model_on_edge_values():
    got = tf32_rna(_f32(*(w for w, _ in EDGES))).view(np.uint32)
    want = np.array([w for _, w in EDGES], np.uint32)
    for (word, _), g, w in zip(EDGES, got, want):
        assert g == w, f"{word:#010x}: got {g:#010x}, want {w:#010x}"
    assert np.isnan(tf32_rna(np.float32(np.nan)))


def _edge_and_random_values() -> np.ndarray:
    """The edge words, and random words of every exponent, subnormals
    included, both signs."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(
        np.uint32)
    words = words[(words & 0x7F800000) != 0x7F800000]   # finite only
    edges = np.array([w for w, _ in EDGES], np.uint32)
    return np.concatenate([edges, words]).view(np.float32)


def test_port_tf32_split_matches_the_model_bit_for_bit():
    """`tf32_split` on a CPU tensor, the plain version of the kernels'
    split, gives the model's big and small parts, word for word; big +
    small carries all but 2^-21 of each value whose residual is a normal
    number."""
    v = _edge_and_random_values()
    big, small = port_rb.tf32_split(torch.from_numpy(v))
    want_big, want_small = split(v)
    np.testing.assert_array_equal(big.numpy().view(np.uint32),
                                  want_big.view(np.uint32))
    np.testing.assert_array_equal(small.numpy().view(np.uint32),
                                  want_small.view(np.uint32))
    for part in (want_big, want_small):
        assert not (part.view(np.uint32) & 0x1FFF).any()
    v64 = v.astype(np.float64)
    ok = (np.abs(v64) >= 2.0 ** -100) & (np.abs(v64) <= 2.0 ** 100)
    err = np.abs(want_big[ok] + want_small[ok].astype(np.float64) - v64[ok])
    assert (err <= 2.0 ** -21 * np.abs(v64[ok])).all()


def _case(C: int, k: int, T: int = 100, seed: int = 0):
    """x [2, T, C] ~ N(0, 1), flax kernels [k, C_in, C_out] ~ N(0, 1/(k C)),
    biases ~ N(0, 0.1): the scales of the card's checks."""
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


def _cols(a: np.ndarray, k: int, d: int) -> np.ndarray:
    """[B, T, C] -> [B, T, k*C]: tap j of row t is row t + (j - r) d, zero
    outside [0, T) (SAME padding), taps then channels as the kernels' K."""
    r = (k - 1) // 2
    T = a.shape[1]
    ap = np.pad(a, ((0, 0), (r * d, r * d), (0, 0)))
    return np.concatenate([ap[:, j * d: j * d + T] for j in range(k)],
                          axis=-1)


def _round_f32(v64: np.ndarray, rounding: str) -> np.ndarray:
    """float64 -> float32, to nearest or toward zero."""
    f = v64.astype(np.float32)
    if rounding == "zero":      # rounded up in magnitude: one step back
        f = (f.view(np.int32) - (np.abs(f) > np.abs(v64))).view(np.float32)
    return f


def _conv_3xtf32(a, w, b, d, rounding="nearest", gather="step",
                 products=3):
    """The kernels' conv. K in steps of 8; each mma adds its 8 products
    (exact: TF32 times TF32 fits float64) to its accumulator and rounds the
    sum to f32, to nearest or toward zero (`rounding`, the tensor cores'
    own, measured on earlier generations). gather="step": the kernels'
    order, a K step's products (big*small, small*big, big*big) in a
    temporary that starts at 0, added to the conv's sum in IEEE f32;
    "slice": the temporary kept over 4 K steps; "one": every mma into the
    conv's sum. products=1: big*big alone, one TF32 product a term."""
    k, C_in, C_out = w.shape
    ab, asm = (p.astype(np.float64) for p in split(_cols(a, k, d)))
    wb, wsm = (p.astype(np.float64)
               for p in split(w.reshape(k * C_in, C_out)))
    pairs = ((ab, wsm), (asm, wb), (ab, wb))[3 - products:]
    every = {"step": 1, "slice": 4, "one": None}[gather]
    acc = np.zeros(a.shape[:2] + (C_out,), np.float32)
    tmp = np.zeros_like(acc) if every else acc
    for i, s in enumerate(range(0, k * C_in, 8)):
        for lhs, rhs in pairs:
            tmp = _round_f32(tmp + lhs[..., s:s + 8] @ rhs[s:s + 8],
                             rounding)
        if every and ((i + 1) % every == 0 or s + 8 >= k * C_in):
            acc, tmp = acc + tmp, np.zeros_like(acc)
    return (tmp if not every else acc) + b


def _conv64(a, w, b, d):
    k, C_in, C_out = w.shape
    return (_cols(a, k, d) @ w.reshape(k * C_in, C_out).astype(np.float64)
            + b)


def _conv_f32(a, w, b, d):
    k, C_in, C_out = w.shape
    return _cols(a, k, d) @ w.reshape(k * C_in, C_out) + b


def _leaky(v):
    return np.where(v > 0, v, v * v.dtype.type(SLOPE))


def _resblock(x, params, conv):
    h = x
    for i, d in enumerate(DIL):
        p1, p2 = params[f"conv1_{i}"], params[f"conv2_{i}"]
        y = conv(_leaky(h), p1["kernel"], p1["bias"], d)
        y = conv(_leaky(y), p2["kernel"], p2["bias"], 1)
        h = h + y
    return h


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("k", [3, 11])
@pytest.mark.parametrize("C", [32, 64])
def test_3xtf32_resblock_model_matches_jax_and_float64(C, k):
    """The kernels' arithmetic, rounding each mma to nearest or toward
    zero, within MODEL_TOL of float64 and of the JAX package's ResBlock1
    (XLA and flax, f32 on the CPU). Printed for contrast: one TF32 product
    a term, and a truncating accumulator kept over 4 K steps or the whole
    conv."""
    x, params = _case(C, k)
    exact = _resblock(x.astype(np.float64), params, _conv64)
    ref_xla = np.asarray(_resblock_xla(jnp.asarray(x), params, k, DIL))
    ref_flax = np.asarray(ResBlock1(C, k, DIL).apply({"params": params},
                                                     jnp.asarray(x)))

    def model(**kw):
        return _resblock(x, params, lambda *a: _conv_3xtf32(*a, **kw))
    errs = {}
    for rounding in ("nearest", "zero"):
        got = model(rounding=rounding)
        assert got.dtype == np.float32 and got.shape == x.shape
        errs.update({(rounding, "float64"): _rel(got, exact),
                     (rounding, "xla"): _rel(got, ref_xla),
                     (rounding, "flax"): _rel(got, ref_flax)})
    contrast = {
        "one TF32 product": _rel(model(products=1), exact),
        "truncated over 4 K steps": _rel(model(rounding="zero",
                                               gather="slice"), exact),
        "truncated over the conv": _rel(model(rounding="zero",
                                              gather="one"), exact),
        "plain f32": _rel(_resblock(x, params, _conv_f32), exact)}
    print(f"C={C} k={k}: 3xTF32 model "
          + ", ".join(f"{r} vs {n} {e:.2e}" for (r, n), e in errs.items())
          + "; against float64: "
          + ", ".join(f"{n} {e:.2e}" for n, e in contrast.items()))
    for key, err in errs.items():
        assert err <= MODEL_TOL, (key, err)
    # what the split buys: one TF32 product a term is far off
    assert contrast["one TF32 product"] > 100 * errs["nearest", "float64"]
