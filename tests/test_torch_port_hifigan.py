"""HiFi-GAN, STFT and denoiser: the port against the JAX package on the
CPU, weights carried across by `models/convert.py`, inputs from numpy."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.models import convert
from tts_arabic_torch.vocoder import denoiser as port_denoiser
from tts_arabic_torch.vocoder import hifigan as port_hifigan
from tts_arabic_tpu.models import torch_export
from tts_arabic_tpu.vocoder import denoiser as jax_denoiser
from tts_arabic_tpu.vocoder.hifigan import Generator, HiFiGANConfig

# the modules (each package re-exports a function of the same name)
port_stft = importlib.import_module("tts_arabic_torch.audio.stft")
jax_stft = importlib.import_module("tts_arabic_tpu.audio.stft")


def _snr_db(ref, got):
    return 10 * np.log10(np.mean(ref ** 2)
                         / (np.mean((ref - got) ** 2) + 1e-20))


@pytest.fixture(scope="module")
def generators():
    cfg = HiFiGANConfig()
    gen = Generator(cfg)
    variables = jax.jit(gen.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 8, cfg.num_mels)))
    port = port_hifigan.Generator(port_hifigan.HiFiGANConfig())
    sd = convert.fold_weight_norm(
        torch_export.hifigan_params_to_torch(variables, cfg))
    port.load_state_dict(convert.to_tensors(sd), strict=True)
    return gen, variables, port.eval()


def _mel(B, F, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, F, 80)) - 5.0).astype(np.float32)


def test_generator_full_width_matches_flax(generators):
    gen, variables, port = generators
    mel = _mel(2, 24)
    ref = np.asarray(jax.jit(gen.apply)(variables, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape == (2, 24 * 256)
    assert _snr_db(ref, got) > 60.0


def test_resblock_stacks_kept_until_a_parameter_changes():
    """`ResBlock1` hands `resblock1` the same stacked weights call after
    call, and new ones once a parameter changes (a loaded state dict) or
    while gradients are recorded; its output follows the new weights."""
    torch.manual_seed(0)
    block = port_hifigan.ResBlock1(8, 3, (1, 3, 5))
    x = torch.randn(1, 20, 8)
    with torch.no_grad():
        first = block._stacks()
        assert all(a is b for a, b in zip(block._stacks(), first))
        y0 = block(x)
        state = {k: v * 0.5 for k, v in block.state_dict().items()}
        block.load_state_dict(state)
        second = block._stacks()
        assert second[0] is not first[0]
        torch.testing.assert_close(second[0], first[0] * 0.5)
        assert not torch.equal(block(x), y0)
    with torch.enable_grad():
        a = block._stacks()
        assert a[0].requires_grad and block._stacks()[0] is not a[0]


def test_bias_spec_matches_jax(generators):
    gen, variables, port = generators
    ref = np.asarray(jax.jit(lambda v: jax_denoiser.compute_bias_spec(
        gen.apply, v))(variables))
    with torch.no_grad():
        got = port_denoiser.compute_bias_spec(port).numpy()
    assert got.shape == ref.shape == (513,)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-6)


def test_chunked_vocode_paths_agree():
    """Direct, batch-split and time-chunk paths give the same waveform (a
    tiny direct_limit forces each path). A narrow generator keeps it cheap:
    the receptive field, which the overlap must cover, does not depend on
    the width."""
    from tts_arabic_torch.models.layers import init_weights
    gen = init_weights(port_hifigan.Generator(port_hifigan.HiFiGANConfig(
        upsample_initial_channel=64)), seed=2).eval()
    calls = []

    def counted(mel):
        calls.append(tuple(mel.shape[:2]))
        return gen(mel)

    B, F = 3, 40
    mel = torch.from_numpy(_mel(B, F, seed=3))
    with torch.no_grad():
        direct = port_hifigan.chunked_vocode(counted, mel).numpy()
        assert calls == [(B, F)]
        # F=40 > window=36, B*F=120 > 50 (f32 halves 100) >= F: batch
        # split, group=1
        bsplit = port_hifigan.chunked_vocode(counted, mel, core=4,
                                             overlap=16,
                                             direct_limit=100).numpy()
        assert calls[1:] == [(1, F)] * B
        # F=40 > window=36 and > direct_limit: time chunks of 4-frame
        # cores, 30 windows in slabs of 8 (first, interior and the
        # clamped last chunk)
        tchunk = port_hifigan.chunked_vocode(counted, mel, core=4,
                                             overlap=16, slab=8,
                                             direct_limit=16).numpy()
        assert calls[1 + B:] == [(8, 36)] * 3 + [(6, 36)]
    assert direct.shape == bsplit.shape == tchunk.shape == (B, F * 256)
    np.testing.assert_allclose(bsplit, direct, atol=2e-6, rtol=0)
    np.testing.assert_allclose(tchunk, direct, atol=2e-6, rtol=0)

    # core >= overlap, but the interior chunk's window is clamped to end
    # at F (2 * 30 + 16 > 70), which moves its core offset off `overlap`
    mel = torch.from_numpy(_mel(1, 70, seed=4))
    with torch.no_grad():
        np.testing.assert_allclose(
            port_hifigan.chunked_vocode(gen, mel, core=30, overlap=16,
                                        direct_limit=16).numpy(),
            gen(mel).numpy(), atol=2e-6, rtol=0)


def test_stft_istft_match_jax():
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, 5120))).astype(np.float32)
    ref = np.asarray(jax_stft.stft(jnp.asarray(x)))
    got = port_stft.stft(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 513, 21)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    back_ref = np.asarray(jax_stft.istft(jnp.asarray(ref), length=5120))
    back = port_stft.istft(torch.from_numpy(got), length=5120).numpy()
    np.testing.assert_allclose(back, back_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(back, x, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(port_stft.hann(1024).numpy(),
                                  np.asarray(jax_stft.hann(1024)))


@pytest.mark.parametrize("strength", [0.005, 0.1])
def test_denoise_matches_jax(strength):
    rng = np.random.default_rng(6)
    audio = (0.2 * rng.standard_normal((2, 6400))).astype(np.float32)
    bias = np.abs(rng.standard_normal(513)).astype(np.float32)
    ref = np.asarray(jax_denoiser.denoise(jnp.asarray(audio),
                                          jnp.asarray(bias), strength))
    got = port_denoiser.denoise(torch.from_numpy(audio),
                                torch.from_numpy(bias), strength).numpy()
    assert got.shape == ref.shape == audio.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
