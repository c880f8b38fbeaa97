"""The port's FastPitch2Wave.tts() against the JAX package's, end to end on
the CPU in f32: the same weights (exported by the JAX package to reference
`.pth` files, loaded by the port through its `.pth` entry), the same
Buckwalter prompts, biased durations, batch_size=2, denoise=0.005.
Per-utterance lengths are exactly equal; waves agree above 50 dB SNR."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tts_arabic_torch.audio import mulaw_decode
from tts_arabic_torch.infer import FastPitch2Wave as PortPipe
from tts_arabic_tpu.audio import mulaw_encode as jax_mulaw_encode
from tts_arabic_tpu.infer import FastPitch2Wave
from tts_arabic_tpu.models import torch_export
from tts_arabic_tpu.models.fastpitch import FastPitch, FastPitchConfig

SMALL = dict(d_model=64, enc_n_layers=2, dec_n_layers=2, enc_filter_size=128,
             dec_filter_size=128, dur_filter_size=32, pitch_filter_size=32,
             energy_filter_size=32)
PROMPTS = ["Sifr wAHid", "kitAbu", "*ahaba Alwaladu <ilaY Almadrasapi"]


def _snr_db(ref, got):
    return 10 * np.log10(np.mean(ref ** 2)
                         / (np.mean((ref - got) ** 2) + 1e-20))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    cfg = FastPitchConfig(**SMALL)
    ref = FastPitch2Wave(seed=0, arabic_in=False, config=cfg)
    # every FastPitch parameter (the aligner's too, as a trained checkpoint
    # has them), then a duration head biased to non-trivial lengths
    init = jax.jit(lambda key, t, x: FastPitch(cfg).init(
        key, t, x, method=lambda m, t, x: (m.infer(t, max_frames=16),
                                           m.align_attention(t, x, None))))
    variables = init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
                     jnp.zeros((1, 16, cfg.n_mel_channels)))
    fc = variables["params"]["duration_predictor"]["fc"]
    fc["bias"] = fc["bias"] + 1.5
    ref.model.variables = variables

    d = tmp_path_factory.mktemp("weights")
    fp = torch_export.save_reference_checkpoint(
        d / "fastpitch.pth",
        torch_export.fastpitch_params_to_torch(variables, cfg),
        config=cfg.to_reference_net_config())
    voc = torch_export.save_reference_checkpoint(
        d / "hifigan.pth",
        torch_export.hifigan_params_to_torch(ref.vocoder_vars,
                                             ref.vocoder_config),
        key="generator")
    port = PortPipe(model_sd_path=fp, vocoder_sd=voc, arabic_in=False,
                    device="cpu")
    return ref, port


def test_tts_matches_jax(pipes):
    ref_pipe, port = pipes
    ref = ref_pipe.tts(PROMPTS, batch_size=2, denoise=0.005)
    got = port.tts(PROMPTS, batch_size=2, denoise=0.005)
    assert len(got) == len(ref) == 3
    for r, g in zip(ref, got):
        assert g.dtype == np.float32 and g.shape == r.shape
        assert len(g) >= 20 * 256
        assert _snr_db(r, g) > 50.0

    # int16 and mu-law: the port's device-side conversions of its own wave
    # equal the JAX package's conversions of the JAX wave (to 1 LSB/code)
    w16 = port.tts(PROMPTS, batch_size=2, denoise=0.005, out_int16=True)
    mu = port.tts(PROMPTS, batch_size=2, denoise=0.005, out_int16="mulaw")
    for r, a, m in zip(ref, w16, mu):
        assert a.dtype == np.int16 and m.dtype == np.uint8
        r16 = (np.clip(r, -1.0, 1.0) * 32767.0).astype(np.int16)
        assert np.abs(a.astype(np.int32) - r16).max() <= 1
        rmu = np.asarray(jax_mulaw_encode(jnp.asarray(r)))
        assert np.abs(m.astype(np.int32) - rmu).max() <= 1
        back = mulaw_decode(m)
        assert back.shape == r.shape and np.isfinite(back).all()


def test_ttmel_and_return_mel_match_jax(pipes):
    ref_pipe, port = pipes
    ref = ref_pipe.model.ttmel(PROMPTS, batch_size=2)
    got = port.model.ttmel(PROMPTS, batch_size=2)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and g.shape[0] == 80
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)
    wave, mel = port.tts(PROMPTS[1], denoise=0.0, return_mel=True)
    assert mel.shape == ref[1].shape
    np.testing.assert_allclose(mel, ref[1], atol=1e-4, rtol=0)
    assert wave.shape == (mel.shape[1] * 256,)


def test_warmup_runs_each_bucket_once(pipes, monkeypatch):
    """warmup() vocodes every (batch size, text bucket, mel bucket) once
    and leaves later results unchanged."""
    from tts_arabic_torch.vocoder import hifigan
    _, port = pipes
    before = port.tts(PROMPTS[1], denoise=0.005)
    shapes = []
    forward = hifigan.Generator.forward

    def counted(self, mel):
        shapes.append(tuple(mel.shape[:2]))
        return forward(self, mel)

    monkeypatch.setattr(hifigan.Generator, "forward", counted)
    port.warmup(batch_sizes=(1, 2), text_buckets=(16, 32),
                mel_buckets=(64, 128))
    assert shapes == [(b, f) for b in (1, 2) for _ in (16, 32)
                      for f in (64, 128)]
    np.testing.assert_array_equal(port.tts(PROMPTS[1], denoise=0.005),
                                  before)
