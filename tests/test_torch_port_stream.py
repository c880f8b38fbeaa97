"""The port's FastPitch2Wave.stream() and long-form synthesis against its
own tts_single and against the JAX package's, on the CPU in f32: the same
weights (one pair of reference `.pth` files, `torch_port_weights.py`,
loaded by both), a narrow FastPitch and a narrow HiFi-GAN with V1's
receptive field, the duration bias raised by 1.0 (TEXT lasts 346
frames, 8 chunks of 48)."""
import numpy as np
import pytest
import torch

from torch_port_weights import write_weights
from tts_arabic_torch.infer import FastPitch2Wave as PortPipe
from tts_arabic_torch.infer import longform as port_longform
from tts_arabic_torch.infer import pipeline as port_pipeline
from tts_arabic_tpu.infer import FastPitch2Wave
from tts_arabic_tpu.infer import longform as jax_longform

TEXT = "bisomi {ll~ahi {lr~aHoma`ni {lr~aHiymi"
PARAGRAPH = "Sifr wAHid. kitAbu؟ *ahaba Alwaladu <ilaY Almadrasapi"
CHUNK = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once, and OpenMP's spinning threads then
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snr_db(ref, got):
    return 10 * np.log10(np.mean(ref ** 2)
                         / (np.mean((ref - got) ** 2) + 1e-20))


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    fp, voc, voc_cfg = write_weights(tmp_path_factory.mktemp("stream"),
                                     duration_bias=1.0)
    kw = dict(vocoder_sd=voc, vocoder_config=voc_cfg, arabic_in=False)
    return FastPitch2Wave(fp, **kw), PortPipe(fp, device="cpu", **kw)


@pytest.mark.parametrize("denoise", [0.004, 0.0])
def test_stream_equals_tts_single(pipes, denoise):
    """The chunks concatenate to the port's own tts_single wave."""
    _, port = pipes
    full = port.tts_single(TEXT, denoise=denoise)
    chunks = list(port.stream(TEXT, chunk_frames=CHUNK, denoise=denoise))
    assert len(chunks) >= 3
    assert all(len(c) == CHUNK * 256 for c in chunks[:-1])
    streamed = np.concatenate(chunks)
    assert streamed.dtype == np.float32 and streamed.shape == full.shape
    np.testing.assert_allclose(streamed, full, atol=2e-5, rtol=0)


def test_stream_matches_jax(pipes):
    ref, port = pipes
    want = list(ref.stream(TEXT, chunk_frames=CHUNK, denoise=0.004))
    got = list(port.stream(TEXT, chunk_frames=CHUNK, denoise=0.004))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert _snr_db(np.concatenate(want), np.concatenate(got)) > 50.0


def test_stream_speculation_fallback(pipes, monkeypatch):
    """With the speculative bucket too small for the utterance, the mel is
    decoded again at its own bucket and the output is unchanged."""
    _, port = pipes
    full = port.tts_single(TEXT, denoise=0.004)
    monkeypatch.setattr(port_pipeline, "STREAM_SPEC_FRAMES", 1)
    decodes = []
    decode = port.model._decode_fn
    monkeypatch.setattr(port.model, "_decode_fn", lambda *a, **kw: (
        decodes.append(kw["max_frames"]) or decode(*a, **kw)))
    streamed = np.concatenate(list(port.stream(TEXT, chunk_frames=CHUNK,
                                               denoise=0.004)))
    assert decodes[0] == port_pipeline._pick_mel_bucket(CHUNK + 32)
    assert decodes[1] > decodes[0]
    np.testing.assert_allclose(streamed, full, atol=2e-5, rtol=0)


def test_stream_int16_and_mulaw_match_jax(pipes):
    ref, port = pipes
    for fmt, dtype in ((True, np.int16), ("mulaw", np.uint8)):
        want = np.concatenate(list(ref.stream(
            TEXT, chunk_frames=CHUNK, denoise=0.004, out_int16=fmt)))
        chunks = list(port.stream(TEXT, chunk_frames=CHUNK, denoise=0.004,
                                  out_int16=fmt))
        assert all(c.dtype == dtype for c in chunks)
        got = np.concatenate(chunks)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() \
            <= 1, fmt


def test_tts_long_joins_sentences_with_pauses(pipes):
    """One wave: the sentences' own waves joined by 0.25 s of silence."""
    _, port = pipes
    kw = dict(batch_size=3, denoise=0.004)
    sentences = port_longform.split_sentences(PARAGRAPH)
    assert sentences == jax_longform.split_sentences(PARAGRAPH)
    waves = port.tts(sentences, **kw)
    pause = int(round(0.25 * port.sample_rate))
    got = port_longform.tts_long(port, PARAGRAPH, **kw)
    assert got.dtype == np.float32
    want = np.concatenate([waves[0], np.zeros(pause, np.float32), waves[1],
                           np.zeros(pause, np.float32), waves[2]])
    np.testing.assert_array_equal(got, want)


def test_tts_long_matches_jax(pipes):
    """mu-law out: the JAX package's wave within 1 code, and code 128 (the
    code of 0.0) for the silence between sentences."""
    ref, port = pipes
    kw = dict(batch_size=3, denoise=0.004, out_int16="mulaw")
    want = jax_longform.tts_long(ref, PARAGRAPH, **kw)
    got = port_longform.tts_long(port, PARAGRAPH, **kw)
    first = len(port.tts(port_longform.split_sentences(PARAGRAPH)[0],
                         denoise=0.004))
    pause = int(round(0.25 * port.sample_rate))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got[first: first + pause] == 128).all()
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_stream_long_matches_jax(pipes):
    ref, port = pipes
    kw = dict(chunk_frames=CHUNK, denoise=0.004, out_int16="mulaw")
    want = list(jax_longform.stream_long(ref, PARAGRAPH, **kw))
    got = list(port_longform.stream_long(port, PARAGRAPH, **kw))
    assert [len(c) for c in got] == [len(c) for c in want]
    silences = [c for c in got if (c == 128).all()]
    assert len(silences) == 2
    assert all(len(c) == int(round(0.25 * port.sample_rate))
               for c in silences)
    diff = np.concatenate(got).astype(np.int32) - np.concatenate(want)
    assert np.abs(diff).max() <= 1


def test_tts_long_refusals_and_empty_text(pipes):
    _, port = pipes
    with pytest.raises(ValueError, match="return_mel"):
        port_longform.tts_long(port, PARAGRAPH, return_mel=True)
    empty = port_longform.tts_long(port, " . ؟ ")
    assert empty.dtype == np.float32 and empty.shape == (0,)
    assert list(port_longform.stream_long(port, "")) == []
