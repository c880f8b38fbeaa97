"""FastPitch inference: the port's layers and model against the JAX
package's flax modules, in f32 on the CPU, with weights carried across by
`models/convert.py` and numpy-seeded inputs. Mel lengths are exactly
equal; mels agree to atol 1e-4 (f32 reassociation through 2+2 layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.models import convert
from tts_arabic_torch.models import layers as port_layers
from tts_arabic_torch.models.fastpitch import (FastPitch as PortFastPitch,
                                               FastPitchConfig as PortCfg,
                                               regulate_len as port_regulate)
from tts_arabic_tpu.models import layers as jax_layers
from tts_arabic_tpu.models.fastpitch import (FastPitch, FastPitchConfig,
                                             regulate_len)

SMALL = dict(d_model=64, enc_n_layers=2, dec_n_layers=2, enc_filter_size=128,
             dec_filter_size=128, dur_filter_size=32, pitch_filter_size=32,
             energy_filter_size=32)
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = FastPitchConfig(**SMALL)
    tokens = jnp.ones((1, 8), jnp.int32)
    mel = jnp.zeros((1, 16, cfg.n_mel_channels))
    init = jax.jit(lambda key, t, x: FastPitch(cfg).init(
        key, t, x, method=lambda m, t, x: (m.infer(t, max_frames=16),
                                           m.align_attention(t, x, None))))
    variables = init(jax.random.PRNGKey(0), tokens, mel)
    # bias the duration head to ~4.5 frames/token so lengths are non-trivial
    fc = variables["params"]["duration_predictor"]["fc"]
    fc["bias"] = fc["bias"] + 1.5
    port = PortFastPitch(PortCfg(**SMALL))
    port.load_state_dict(convert.to_tensors(
        convert.fastpitch_params_to_torch(variables, cfg)), strict=True)
    return FastPitch(cfg), variables, port.eval()


def _tokens(seed=0, B=3, T=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 40, (B, T))
    for b, n in enumerate(rng.integers(5, T + 1, B)):
        tokens[b, n:] = 0
    tokens[0, :] = rng.integers(1, 40, T)       # one row at full length
    return tokens


def test_sinusoidal_positions_and_sequence_mask():
    np.testing.assert_array_equal(port_layers.sinusoidal_positions(50, 64),
                                  jax_layers.sinusoidal_positions(50, 64))
    lens = np.array([0, 3, 7])
    np.testing.assert_array_equal(
        port_layers.sequence_mask(torch.from_numpy(lens), 7).numpy(),
        np.asarray(jax_layers.sequence_mask(jnp.asarray(lens), 7)))


@pytest.mark.parametrize("pace", [1.0, 1.3])
def test_regulate_len(pace):
    rng = np.random.default_rng(1)
    dur = (rng.random((3, 10)) * 6).astype(np.float32)
    dur[2, 6:] = 0
    enc = rng.standard_normal((3, 10, 16)).astype(np.float32)
    ref, ref_lens = regulate_len(jnp.asarray(dur), jnp.asarray(enc), 48, pace)
    got, got_lens = port_regulate(torch.from_numpy(dur),
                                  torch.from_numpy(enc), 48, pace)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("part", ["encoder", "duration_predictor",
                                  "pitch_predictor", "decoder"])
def test_layers_in_place(models, part):
    """FFTransformer (SelfAttention, ConvFFN, FFTBlock) and
    TemporalPredictor (ConvReLUNorm) on the model's own weights."""
    model, variables, port = models
    rng = np.random.default_rng(2)
    if part == "encoder":
        tokens = _tokens()
        ref, ref_mask = model.apply(
            variables, jnp.asarray(tokens), method=lambda m, t: m.encoder(t))
        with torch.no_grad():
            got, got_mask = port.encoder(torch.from_numpy(tokens))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    elif part == "decoder":
        x = rng.standard_normal((2, 40, 64)).astype(np.float32)
        lens = np.array([40, 23])
        ref, _ = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                             method=lambda m, x, n: m.decoder(x, seq_lens=n))
        with torch.no_grad():
            got, _ = port.decoder(torch.from_numpy(x),
                                  seq_lens=torch.from_numpy(lens))
    else:
        x = rng.standard_normal((2, 20, 64)).astype(np.float32)
        mask = np.arange(20)[None] < np.array([[20], [11]])
        ref = model.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                          method=lambda m, x, k: getattr(m, part)(x, k))
        with torch.no_grad():
            got = getattr(port, part)(torch.from_numpy(x),
                                      torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pitch_mul,pitch_add", [(1.0, 0.0), (1.2, 0.3)])
def test_infer_matches_jax(models, pitch_mul, pitch_add):
    model, variables, port = models
    tokens = _tokens(seed=3)
    ref = model.apply(variables, jnp.asarray(tokens), max_frames=192,
                      pitch_mul=pitch_mul, pitch_add=pitch_add,
                      method=FastPitch.infer)
    with torch.no_grad():
        got = port.infer(torch.from_numpy(tokens), max_frames=192,
                         pitch_mul=pitch_mul, pitch_add=pitch_add)
    lens = np.asarray(ref["mel_lens"])
    assert lens.min() > 20 and lens.max() < 192
    np.testing.assert_array_equal(got["mel_lens"].numpy(), lens)
    for key in ("dur_pred", "pitch_pred", "energy_pred", "mel"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_encode_decode_split_equals_infer(models):
    _, _, port = models
    tokens = torch.from_numpy(_tokens(seed=4))
    with torch.no_grad():
        full = port.infer(tokens, max_frames=128, pace=1.25)
        enc = port.encode_infer(tokens)
        mel, lens = port.decode(enc["enc_out"], enc["dur_pred"], 128, 1.25)
    np.testing.assert_array_equal(lens.numpy(), full["mel_lens"].numpy())
    np.testing.assert_array_equal(mel.numpy(), full["mel"].numpy())
