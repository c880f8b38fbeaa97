"""AOT serving bundles of the port (`apps.export_serving`) on the CPU: the
ResBlock1 kernel as the custom op `tts_arabic::resblock1`, a FastPitch
bundle against the port's live `tts(out_int16=True)` (equal) and against
the JAX package's `ServingBundle` on the same weights, the capacity
guards, and a Tacotron2 bundle against the port's live path (8 LSB).
The weights are seeded narrow models written as reference `.pth` files
that both packages load (`torch_port_weights`); the pipelines' default
vocoder is pointed at the narrow HiFi-GAN for the length of the module.
"""
import json

import numpy as np
import pytest
import torch

from torch_port_weights import (SMALL_TACOTRON2, write_tacotron2_weights,
                                write_weights)
from tts_arabic_torch.apps import export_serving as es
from tts_arabic_torch.infer import FastPitch2Wave, Tacotron2Wave
from tts_arabic_torch.infer import pipeline as port_pipeline
from tts_arabic_torch.infer import tacotron_pipeline as port_tp
from tts_arabic_torch.models.tacotron2 import Tacotron2Config
from tts_arabic_torch.ops import resblock as rb
from tts_arabic_tpu.apps import export_serving as jax_es
from tts_arabic_tpu.infer import pipeline as jax_pipeline

# land in the 128-frame bucket of both the live ladder (64, 128, ...) and
# the bundle's (128, 256): the port's decoder attention sums over the
# whole bucket, so a wave is bit-equal only at the same bucket
TEXTS = ["kitAbun", "salAm"]
LSB = 8                 # Tacotron2 bundle vs live (JAX test_apps.py:342)
# the port's bundle vs the JAX package's: both decode and vocode in bf16,
# rounding at different places; the two live bf16 pipelines' waves lie
# 1.97% and 2.00% apart here (rel-RMSE; 6e-5 in f32), and each bundle
# reproduces its own pipeline, so the bound is 3% (SNR > 30.5 dB)
JAX_REL_RMSE = 0.03


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded FastPitch, Tacotron2 and narrow HiFi-GAN `.pth` files; the
    vocoder's conv_post is scaled up 3000-fold so that the waves are far
    from int16's silence. Every pipeline built in this module without
    vocoder weights takes this vocoder (a checkpointed pipeline's
    default), the JAX package's too."""
    d = tmp_path_factory.mktemp("bundle_weights")
    fp, voc, voc_cfg = write_weights(d)
    sd = torch.load(voc)["generator"]
    sd["conv_post.weight"] = sd["conv_post.weight"] * 3000.0
    loud = d / "hifigan_loud.pth"
    torch.save({"generator": sd}, loud)
    t2 = write_tacotron2_weights(d, Tacotron2Config(**SMALL_TACOTRON2))

    def vocoder(sd_path, config_path, enabled=True):
        return str(loud), voc_cfg

    with pytest.MonkeyPatch.context() as mp:
        for module in (port_pipeline, port_tp, jax_pipeline):
            mp.setattr(module, "_default_vocoder_paths", vocoder)
        yield dict(fastpitch=fp, tacotron2=t2, root=d)


@pytest.fixture(scope="module")
def fp_bundle(weights):
    return es.export_bundle(weights["root"] / "fp_bundle",
                            weights["fastpitch"], batch_sizes=(2,),
                            text_buckets=(16,), mel_buckets=(128, 256),
                            device="cpu")


def _stacks(C, k, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = 3
    w1, w2 = (torch.randn(n, C, C, k, generator=g) / (k * C) ** 0.5
              for _ in range(2))
    b1, b2 = (0.1 * torch.randn(n, C, generator=g) for _ in range(2))
    x = torch.randn(2, 37, C, generator=g).to(dtype)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("C,k,dtype", [(64, 3, torch.float32),
                                       (256, 7, torch.bfloat16),
                                       (32, 11, torch.bfloat16)])
def test_resblock_op_passes_opcheck(C, k, dtype):
    """The op's schema, fake (meta) kernel and dispatch (opcheck), and its
    CPU body equal to `resblock1` on the same weights in the Conv1d
    layout."""
    x, w1, b1, w2, b2 = _stacks(C, k, dtype)
    args = (x, rb.kernel_weights(w1, dtype), b1, rb.kernel_weights(w2, dtype),
            b2, k, [1, 3, 5])
    torch.library.opcheck(torch.ops.tts_arabic.resblock1.default, args)
    got = torch.ops.tts_arabic.resblock1(*args)
    want = rb.resblock1(x, w1.to(dtype), b1, w2.to(dtype), b2, k, (1, 3, 5))
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="kernel layout"):
        torch.ops.tts_arabic.resblock1(x, w1.to(dtype), b1, w2.to(dtype),
                                       b2, k, [1, 3, 5])


def test_gradient_route_is_unchanged_by_the_op():
    """A call that records a gradient still runs through
    `ResBlock1Function` (forward as the op, backward the plain recompute),
    whose gradients equal plain autograd's."""
    x, w1, b1, w2, b2 = _stacks(64, 3, torch.float32, seed=1)
    leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y = rb.resblock1(*leaves, 3, (1, 3, 5))
    assert y.grad_fn.name() == "ResBlock1FunctionBackward"
    op = torch.ops.tts_arabic.resblock1(
        x, rb.kernel_weights(w1, x.dtype), b1, rb.kernel_weights(w2, x.dtype),
        b2, 3, [1, 3, 5])
    torch.testing.assert_close(y.detach(), op, rtol=0, atol=0)
    got = torch.autograd.grad(y.square().sum(), leaves)
    plain = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    want = torch.autograd.grad(
        rb.resblock1_plain(*plain, 3, (1, 3, 5)).square().sum(), plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_fastpitch_bundle_equals_the_live_path(weights, fp_bundle):
    """ServingBundle (batch 2, text 16, mels 128/256): no checkpoint and
    no model at serving time, the ResBlocks as the custom op inside the
    wave programs, int16 waves equal to the live `tts(out_int16=True)`."""
    man = json.loads((fp_bundle / "manifest.json").read_text())
    assert man["model"] == "fastpitch2wave" and man["device"] == "cpu"
    assert sorted(p.name for p in fp_bundle.glob("*.pt2")) == [
        "encode_b2_t16.pt2", "wave_b2_m128.pt2", "wave_b2_m256.pt2"]
    program = torch.export.load(fp_bundle / "wave_b2_m128.pt2")
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.tts_arabic.resblock1.default) == 12
    got = es.ServingBundle(fp_bundle).tts(TEXTS, denoise=0.004)
    pipe = FastPitch2Wave(weights["fastpitch"], arabic_in=False,
                          compute_dtype=torch.bfloat16, device="cpu")
    want = pipe.tts(TEXTS, denoise=0.004, batch_size=2, out_int16=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == w.shape
        assert 64 * 256 < len(g) <= 128 * 256
        np.testing.assert_array_equal(g, w)


def test_fastpitch_bundle_matches_jax_bundle(weights, fp_bundle, tmp_path):
    """The port's bundle and the JAX package's ServingBundle, exported from
    the same `.pth` files: equal lengths, int16 waves within JAX_REL_RMSE
    of each other."""
    out = jax_es.export_bundle(tmp_path / "jax_bundle",
                               weights["fastpitch"], batch_sizes=(2,),
                               text_buckets=(16,), mel_buckets=(128, 256))
    want = jax_es.ServingBundle(out).tts(TEXTS, denoise=0.004)
    got = es.ServingBundle(fp_bundle).tts(TEXTS, denoise=0.004)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.int16
        g, w = g.astype(np.float64), w.astype(np.float64)
        assert np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)) \
            < JAX_REL_RMSE


def test_capacity_guards_raise(weights, tmp_path):
    out = es.export_bundle(tmp_path / "guards", weights["fastpitch"],
                           batch_sizes=(1,), text_buckets=(16,),
                           mel_buckets=(64,), device="cpu")
    bundle = es.ServingBundle(out)
    with pytest.raises(ValueError, match="batch"):
        bundle.tts(["Sifr", "kitAb"])
    with pytest.raises(ValueError, match="text bucket"):
        bundle.tts(["b a " * 20])
    with pytest.raises(ValueError, match="mel bucket"):
        bundle.tts(["kitAbun"])         # 86 frames > 64
    with pytest.raises(ValueError, match="tacotron2wave"):
        es.Tacotron2ServingBundle(out)


def test_tacotron2_bundle_within_8_lsb_of_the_live_path(weights, tmp_path):
    """Encode, decode blocks (the host reads the run flag after each),
    finish and wave programs at max_steps 64 against the live
    `Tacotron2Wave(compute_dtype=bf16)` capped at 64 steps: one text ends
    safe (no EOS truncation), one unsafe (truncated on its attention)."""
    texts = ["kitAbun", "Sifr"]
    out = es.export_bundle_tacotron(
        tmp_path / "t2", weights["tacotron2"], batch_sizes=(2,),
        text_buckets=(16,), mel_buckets=(64, 128), max_steps=64,
        device="cpu")
    assert len(list(out.glob("*.pt2"))) == 5
    got = es.Tacotron2ServingBundle(out).tts(texts, denoise=0.004)
    live = Tacotron2Wave(weights["tacotron2"], arabic_in=False,
                         compute_dtype=torch.bfloat16, device="cpu")
    live.model.decoder_max_step = 64
    want = live.tts(texts, denoise=0.004, batch_size=2, out_int16=True)
    assert len(want[0]) == 64 * 256 and len(want[1]) < 64 * 256
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape == w.shape
        assert np.abs(w).max() > 30 * LSB     # far above the tolerance
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= LSB
