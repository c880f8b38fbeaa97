"""The port's Tacotron2Wave against the JAX package's, on the CPU in f32:
one reference Tacotron2 `.pth` (JAX's SMALL widths, 3 speakers, seeded
numpy weights, the gate shut so every decode runs to the 96-step cap) and
a narrow HiFi-GAN with V1's receptive field, loaded by both; prenet
dropout off for parity, on for the port's own checks. Then the inference
CLI with `--model tacotron2` and the HTTP server with a `tacotron2`
registry entry."""
import dataclasses
import json
import threading
import urllib.error
import urllib.request
import wave as wave_mod

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_weights import (SMALL_TACOTRON2, write_tacotron2_weights,
                                write_weights)
from tts_arabic_torch.apps import inference, server
from tts_arabic_torch.audio import mulaw_encode
from tts_arabic_torch.infer import Tacotron2Wave as PortWave
from tts_arabic_torch.infer import tacotron_pipeline as port_tp
from tts_arabic_torch.models.tacotron2 import Tacotron2Config
from tts_arabic_tpu.infer import Tacotron2Wave as JaxWave
from tts_arabic_tpu.infer import tacotron_pipeline as jax_tp

CONFIG = Tacotron2Config(**dict(SMALL_TACOTRON2, num_speakers=3,
                                speaker_embedding_dim=8, prenet_dropout=0.0))
ARABIC = "ذَهَبَ الوَلَدُ"
TEXTS = [ARABIC, "صِفر", "كِتاب"]   # the last two end unsafe: truncated
SPEAKERS = [2, 0, 1]
STEPS = 96


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
    """The vocoder's conv_post is scaled up 3000-fold: the seeded narrow
    HiFi-GAN alone gives waves near 4e-5, too quiet for int16 and mu-law
    to be told apart from silence."""
    d = tmp_path_factory.mktemp("tacotron")
    _, voc, voc_cfg = write_weights(d)
    sd = torch.load(voc)["generator"]
    sd["conv_post.weight"] = sd["conv_post.weight"] * 3000.0
    torch.save({"generator": sd}, d / "hifigan_loud.pth")
    return dict(pth=write_tacotron2_weights(d, CONFIG),
                vocoder_sd=str(d / "hifigan_loud.pth"),
                vocoder_config=voc_cfg)


def _close(got, want, rel=1e-4):
    """max |got - want| within `rel` of the reference's peak."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _differ(a, b):
    return np.abs(a - b).max() > 1e-3 * np.abs(b).max()


def _port(weights, **kw):
    pipe = PortWave(weights["pth"], vocoder_sd=weights["vocoder_sd"],
                    vocoder_config=weights["vocoder_config"], device="cpu",
                    **kw)
    pipe.model.decoder_max_step = STEPS
    return pipe


@pytest.fixture(scope="module")
def pipes(weights):
    ref = JaxWave(weights["pth"], vocoder_sd=weights["vocoder_sd"],
                  vocoder_config=weights["vocoder_config"])
    ref.model.decoder_max_step = STEPS
    return ref, _port(weights)


@pytest.fixture(scope="module")
def dropout_pipe(weights):
    """The same weights with the prenet dropout on (the reference's
    inference default), port only: its masks cannot match JAX's bits."""
    return _port(weights, config=dataclasses.replace(CONFIG,
                                                     prenet_dropout=0.5))


@pytest.mark.parametrize("rate", [0.8, 1.0, 1.25, 1.5])
def test_resize_mel_matches_jax(rate):
    mel = np.random.default_rng(0).standard_normal((80, 57)).astype(
        np.float32)
    got, want = port_tp.resize_mel(mel, rate), jax_tp.resize_mel(mel, rate)
    assert got.shape == want.shape == (80, int(57 / rate))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if rate == 1.0:
        assert got is mel


def test_truncate_mel_and_rules_match_jax():
    from tts_arabic_torch.text import symbols
    assert [port_tp.needs_postprocessing(s) for s in symbols] == \
        [jax_tp.needs_postprocessing(s) for s in symbols]
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((80, 30)).astype(np.float32)
    for attn in (rng.random(30).astype(np.float32),
                 np.zeros(30, np.float32)):
        got = port_tp.truncate_mel(mel, attn)
        np.testing.assert_array_equal(got, jax_tp.truncate_mel(mel, attn))
        np.testing.assert_array_equal(got[:, -1], got[:, -4])


def test_tts_matches_jax(pipes):
    """The fused list path (device-side EOS truncation), per-utterance
    speakers, batch 2: equal lengths, waves within 1e-5."""
    ref, port = pipes
    kw = dict(denoise=0.004, batch_size=2, speaker_id=SPEAKERS)
    want = ref.tts(TEXTS, **kw)
    got = port.tts(TEXTS, **kw)
    assert [len(w) for w in got] == [len(w) for w in want]
    assert len(got[0]) == STEPS * 256 and len(got[1]) < STEPS * 256
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        _close(g, w)


def test_fused_path_equals_host_path(pipes):
    """tts(list) without speed truncates and vocodes on the device; it
    gives the host path's waves (tts_single: numpy truncate_mel, then a
    separate vocode), and int16 and mu-law are those waves converted."""
    _, port = pipes
    host = [port.tts_single(t, denoise=0.004, speaker_id=s)
            for t, s in zip(TEXTS, SPEAKERS)]
    kw = dict(denoise=0.004, batch_size=2, speaker_id=SPEAKERS)
    fused = port.tts(TEXTS, **kw)
    for h, f in zip(host, fused):
        _close(f, h)
    pcm = port.tts(TEXTS, out_int16=True, **kw)
    codes = port.tts(TEXTS, out_int16="mulaw", **kw)
    for h, p, c in zip(host, pcm, codes):
        assert p.dtype == np.int16 and c.dtype == np.uint8
        np.testing.assert_allclose(p / 32767.0, h, atol=2e-4, rtol=0)
        want = mulaw_encode(torch.from_numpy(h)).numpy().astype(int)
        assert np.abs(c.astype(int) - want).max() <= 1


def test_host_path_speed_and_return_mel(pipes):
    """speed= takes the host path: each mel is the cubic resize of the
    unsped one, and int16 is converted on the device there too."""
    _, port = pipes
    kw = dict(denoise=0.004, batch_size=2)
    waves, mels = port.tts(TEXTS, return_mel=True, **kw)
    fast, fast_mels = port.tts(TEXTS, speed=1.25, return_mel=True, **kw)
    for m, f, w in zip(mels, fast_mels, fast):
        np.testing.assert_allclose(f, port_tp.resize_mel(m, 1.25), atol=1e-6)
        assert len(w) == f.shape[1] * 256
    pcm = port.tts(TEXTS, speed=1.25, out_int16=True, **kw)
    for w, p in zip(fast, pcm):
        np.testing.assert_allclose(p / 32767.0, w, atol=2e-4, rtol=0)


@pytest.mark.parametrize("cap", [STEPS, 90])
def test_stream_equals_tts_single(pipes, cap, monkeypatch):
    """Segments of 32 steps (the first 32 + margin); at a cap of 90 (no
    multiple of 32) the stream stops at the cap as tts_single does."""
    _, port = pipes
    monkeypatch.setattr(port.model, "decoder_max_step", cap)
    ref = port.tts_single(ARABIC, denoise=0.004, postprocess_mel=False)
    chunks = list(port.stream(ARABIC, chunk_frames=32, denoise=0.004))
    assert len(chunks) >= 3 and len(ref) == cap * 256
    np.testing.assert_allclose(np.concatenate(chunks), ref, atol=1e-5,
                               rtol=0)
    pcm = np.concatenate(list(port.stream(ARABIC, chunk_frames=32,
                                          denoise=0.004, out_int16=True)))
    assert pcm.dtype == np.int16
    np.testing.assert_allclose(pcm / 32767.0, ref, atol=2e-4, rtol=0)


def test_trailing_punctuation(pipes, weights):
    """Sentence-final punctuation is dropped at the token level (the
    EOS-postprocess index stays consistent); strict_text raises the
    reference's KeyError."""
    _, port = pipes
    bare = port.tts(ARABIC, denoise=0.0)
    np.testing.assert_array_equal(port.tts(ARABIC + ".", denoise=0.0), bare)
    question = port.tts("كيف حالك؟", denoise=0.0)
    assert question.ndim == 1 and len(question) and np.isfinite(question).all()
    strict = _port(weights, strict_text=True)
    with pytest.raises(KeyError):
        strict.model.tokenize(ARABIC + ".")


def test_per_utterance_speakers(pipes):
    _, port = pipes
    kw = dict(denoise=0.0, batch_size=3)
    waves = port.tts(TEXTS, speaker_id=SPEAKERS, **kw)
    for t, s, w in zip(TEXTS, SPEAKERS, waves):
        np.testing.assert_allclose(w, port.tts(t, speaker_id=[s], denoise=0.0),
                                   atol=1e-5)
    other = port.tts(TEXTS, speaker_id=0, **kw)
    assert _differ(other[0], waves[0])
    with pytest.raises(ValueError, match="speaker_id"):
        port.tts(TEXTS, speaker_id=[0, 1], **kw)


def test_dropout_masks_follow_the_generator(dropout_pipe):
    pipe = dropout_pipe
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    a = pipe.tts(TEXTS, denoise=0.0, batch_size=2, generator=gen(5))
    b = pipe.tts(TEXTS, denoise=0.0, batch_size=2, generator=gen(5))
    c = pipe.tts(TEXTS, denoise=0.0, batch_size=2, generator=gen(6))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert _differ(a[0], c[0])
    d = pipe.tts(ARABIC, denoise=0.0)   # a fresh generator seeded 0
    np.testing.assert_array_equal(d, pipe.tts(ARABIC, denoise=0.0))


def test_stream_equals_tts_single_with_dropout(dropout_pipe):
    """Dropout on: the stream draws the call's masks as tts_single does and
    indexes them with the global step, so the waves agree to 1e-5."""
    ref = dropout_pipe.tts_single(ARABIC, denoise=0.004,
                                  postprocess_mel=False)
    got = np.concatenate(list(dropout_pipe.stream(ARABIC, chunk_frames=32,
                                                  denoise=0.004)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_warmup_leaves_results_unchanged(pipes):
    _, port = pipes
    before = port.tts([ARABIC], denoise=0.004)[0]
    port.warmup(batch_sizes=(1,), text_buckets=(16,), denoise=0.004)
    np.testing.assert_array_equal(before,
                                  port.tts([ARABIC], denoise=0.004)[0])


def test_int8_is_refused(weights):
    """int8 claims the MRF stages of 64 channels or more: this narrow
    vocoder's are 32 at most, so quantize="int8" is refused before any
    decode (the JAX package refuses it too, after its calibration pass),
    and an unknown mode before anything is loaded. The int8 path itself:
    test_torch_port_int8.py."""
    with pytest.raises(ValueError, match="no MRF stage"):
        _port(weights, quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize"):
        _port(weights, quantize="int4")


# ---- the apps ----------------------------------------------------------------

@pytest.fixture
def capped(monkeypatch):
    """The apps build their pipelines inside: cap those decodes at STEPS,
    as every pipeline of this module is (the gate is shut)."""
    init = PortWave.__init__

    def capped_init(self, *a, **kw):
        init(self, *a, **kw)
        self.model.decoder_max_step = STEPS
    monkeypatch.setattr(PortWave, "__init__", capped_init)


def test_inference_cli_tacotron2(weights, capped, tmp_path):
    lst = tmp_path / "list.txt"
    lines = ["Sifr wAHid", "kitAbu", "marHaban bikum"]
    lst.write_text("\n".join(lines) + "\n", encoding="utf-8")
    out = tmp_path / "out"
    page = inference.main([
        "--model", "tacotron2", "--list", str(lst), "--checkpoint",
        weights["pth"], "--vocoder-sd", weights["vocoder_sd"],
        "--vocoder-config", weights["vocoder_config"], "--buckwalter",
        "--batch-size", "2", "--out-dir", str(out), "--device", "cpu"])
    assert "wave_0002.wav" in page.read_text()
    pipe = PortWave(weights["pth"], vocoder_sd=weights["vocoder_sd"],
                    vocoder_config=weights["vocoder_config"],
                    arabic_in=False, device="cpu")
    assert pipe.compute_dtype is None   # the JAX CLI decodes Tacotron2 in f32
    want = pipe.tts(lines, speed=1.0, denoise=0.005, batch_size=2)
    for i, w in enumerate(want):
        with wave_mod.open(str(out / f"wave_{i:04d}.wav")) as f:
            got = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        assert len(got) >= 256
        np.testing.assert_array_equal(
            got, (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16))


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_server_with_a_tacotron2_entry(weights, capped):
    """The registry's tacotron2 entry warms up with its own warmup(),
    serves /api/tts, and streams on /api/tts/stream without a speed; a
    rate other than 1 on the stream is a 400 that says why."""
    from http.server import ThreadingHTTPServer
    manager = server.TTSManager([{
        "name": "t2-small", "type": "tacotron2",
        "checkpoint": weights["pth"],
        "vocoder_sd": weights["vocoder_sd"],
        "vocoder_config": weights["vocoder_config"]}], device="cpu")
    _, model = manager.models[0]
    assert isinstance(model, PortWave)
    assert manager.warmup() > 0
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                server.make_handler(manager))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    text = "marHaban bikum"
    try:
        with _post(port, "/api/tts", {"buckw": text, "rate": 1.25}) as r:
            data = json.loads(r.read())
        assert data["waves"][0]["model"] == "t2-small"
        with _post(port, "/api/tts/stream",
                   {"buckw": text, "format": "mulaw"}) as r:
            assert r.headers["X-Model"] == "t2-small"
            got = np.frombuffer(r.read(), np.uint8)
        want = np.concatenate(list(model.stream(text, denoise=0.005,
                                                out_int16="mulaw")))
        np.testing.assert_array_equal(got, want)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/api/tts/stream", {"buckw": text, "rate": 1.25})
        assert e.value.code == 400
        assert b"tacotron2" in e.value.read()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_resize_jax_reference_is_cubic_not_bicubic():
    """The resize is Keys a = -0.5 with antialiasing, not torch's bicubic
    (a = -0.75, clamped edges): on a shrink they differ."""
    mel = np.random.default_rng(2).standard_normal((4, 40)).astype(
        np.float32)
    ours = port_tp.resize_mel(mel, 1.5)
    torch_bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(mel)[None, None], size=(4, 26), mode="bicubic",
        align_corners=False)[0, 0].numpy()
    assert not np.allclose(ours, torch_bicubic, atol=1e-3)
    np.testing.assert_allclose(
        ours, np.asarray(jax_tp.resize_mel(jnp.asarray(mel), 1.5)), atol=1e-5)
