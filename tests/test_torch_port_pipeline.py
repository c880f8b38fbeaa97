"""The port's FastPitch2Wave.tts() against the JAX package's, end to end on
the CPU in f32: the same weights (exported by the JAX package to reference
`.pth` files, loaded by the port through its `.pth` entry), the same
Buckwalter prompts, biased durations, batch_size=2, denoise=0.005.
Per-utterance lengths are exactly equal; waves agree above 50 dB SNR.
Then, on the port alone: length-grouped vocoding against the whole batch
at its bucket."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_weights import write_int8_vocoder, write_weights
from tts_arabic_torch.audio import mulaw_decode
from tts_arabic_torch.infer import FastPitch2Wave as PortPipe
from tts_arabic_torch.infer import pipeline as port_pipeline
from tts_arabic_torch.runtime import profiling
from tts_arabic_torch.vocoder import hifigan
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


# ---- length-grouped vocoding (port only, seeded narrow weights) ----------

# at 6 frames a token: "kitAbu" x k is 7k tokens with the separators and
# the end token, 42k frames; "bAb bAb" 8 tokens, 48 frames. One row of 252
# frames (its group capped at the 256 bucket, vocoded alone), three of 84
# (a group at 128) and five of 48 (a group at 64, their frames + 16)
GROUPED = ["bAb bAb" if k == 0 else " ".join(["kitAbu"] * k)
           for k in (0, 2, 6, 0, 2, 0, 0, 2, 0)]
FRAMES = [48 if k == 0 else 42 * k for k in (0, 2, 6, 0, 2, 0, 0, 2, 0)]


def _six_frames_a_token(pipe):
    """Every token's predicted duration rounds to 6 frames."""
    fc = pipe.model.model.duration_predictor.fc
    with torch.no_grad():
        fc.weight.zero_()
        fc.bias.fill_(float(np.log(7.0)))
    return pipe


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    """FastPitch2Wave on seeded narrow weights in f32 (`torch_port_weights`),
    and the same FastPitch with the int8 vocoder, calibrated. One intra-op
    thread from here to the end of the module: the suite runs several
    pytest workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _grouped_pipes(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _grouped_pipes(tmp_path_factory):
    d = tmp_path_factory.mktemp("grouped_weights")
    fp, voc, voc_cfg = write_weights(d)
    voc8, voc8_cfg = write_int8_vocoder(d, gain=300.0)
    pipe = _six_frames_a_token(PortPipe(
        model_sd_path=fp, vocoder_sd=voc, vocoder_config=voc_cfg,
        arabic_in=False, device="cpu"))
    int8 = _six_frames_a_token(PortPipe(
        model_sd_path=fp, vocoder_sd=voc8, vocoder_config=voc8_cfg,
        arabic_in=False, device="cpu"))
    int8.calibrate_int8(texts=GROUPED[1:3])
    return dict(pipe=pipe, int8=int8, fastpitch=fp, vocoder=voc,
                vocoder_config=voc_cfg)


@contextlib.contextmanager
def _generator_calls():
    """The mel shape [B, frames] of every generator call inside."""
    calls = []
    forward = hifigan.Generator.forward

    def counted(self, mel, **kw):
        calls.append(tuple(mel.shape[:2]))
        return forward(self, mel, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hifigan.Generator, "forward", counted)
        yield calls


def _whole_batch(monkeypatch):
    """Every batch vocoded in one call at its bucket, as before length
    groups."""
    monkeypatch.setattr(port_pipeline, "length_groups",
                        lambda lens, bucket: [(list(range(len(lens))),
                                               bucket)])


def _assert_close_rows(got, want, rel=1e-5):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w)


def test_tts_vocodes_length_groups_as_the_whole_batch(grouped, monkeypatch):
    """tts() of rows of very different lengths vocodes them in three
    groups (one capped at the bucket and holding one row, one whose rows
    have just 16 frames past them); every
    utterance's samples equal those of the batch vocoded whole at its
    bucket (f32, the CPU)."""
    pipe = grouped["pipe"]
    with _generator_calls() as calls:
        got = pipe.tts(GROUPED, batch_size=len(GROUPED), denoise=0.005)
    assert [len(w) // 256 for w in got] == FRAMES
    assert sorted(calls) == [(1, 256), (3, 128), (5, 64)]
    _whole_batch(monkeypatch)
    with _generator_calls() as calls:
        want = pipe.tts(GROUPED, batch_size=len(GROUPED), denoise=0.005)
    assert calls == [(len(GROUPED), 256)]
    _assert_close_rows(got, want)


def test_tts_batch_int8_vocodes_length_groups_as_the_whole_batch(
        grouped, monkeypatch):
    """The same through tts_batch() after calibrate_int8: the int8
    generator is what each group runs."""
    pipe = grouped["int8"]
    with _generator_calls() as calls:
        got = pipe.tts_batch(GROUPED, denoise=0.005)
    assert sorted(calls) == [(1, 256), (3, 128), (5, 64)]
    _whole_batch(monkeypatch)
    want = pipe.tts_batch(GROUPED, denoise=0.005)
    _assert_close_rows(got, want)


def test_one_row_is_vocoded_at_its_length(grouped):
    """A one-row call is one group at its frames + 16, rounded up to 64."""
    with _generator_calls() as calls:
        wave = grouped["pipe"].tts(GROUPED[1], denoise=0.005)
    assert len(wave) == 84 * 256 and calls == [(1, 128)]


def test_grouped_vocode_gathers_rows_out_of_order(grouped):
    """Groups of rows that are not contiguous in the batch are gathered
    and written back to their own rows: each row's frames equal the whole
    call's, the wave is zero past its group's frames."""
    gen = grouped["pipe"].vocoder
    mel = torch.randn(4, 192, 80, generator=torch.Generator().manual_seed(0))
    lens = [40, 170, 30, 100]
    groups = [([0, 2], 64), ([1, 3], 192)]
    with torch.no_grad():
        whole = gen(mel)
        got = hifigan.grouped_vocode(gen, mel, groups)
    assert got.shape == whole.shape
    for i, n in enumerate(lens):
        w, g = whole[i, : n * 256].numpy(), got[i, : n * 256].numpy()
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    assert not got[[0, 2], 64 * 256:].any()


def test_warmup_and_export_vocode_whole_batches(grouped, monkeypatch,
                                                tmp_path):
    """warmup() and the exported wave programs, which have no host
    lengths, make one generator call a `_wave_fn` at its max_frames."""
    from tts_arabic_torch.apps import export_serving as es
    with _generator_calls() as calls:
        grouped["pipe"].warmup(batch_sizes=(3,), text_buckets=(16,),
                               mel_buckets=(64, 192))
    assert calls == [(3, 64), (3, 192)]

    def vocoder(sd_path, config_path, enabled=True):
        return grouped["vocoder"], grouped["vocoder_config"]

    programs = []

    def run_once(fn, args, path):       # the program's function, no trace
        with _generator_calls() as calls:
            fn(*args)
        programs.append(calls)

    monkeypatch.setattr(port_pipeline, "_default_vocoder_paths", vocoder)
    monkeypatch.setattr(es, "_export", run_once)
    es.export_bundle(tmp_path / "bundle", grouped["fastpitch"],
                     batch_sizes=(2,), text_buckets=(16,),
                     mel_buckets=(64, 128), device="cpu")
    assert programs == [[], [(2, 64)], [(2, 128)]]    # encode, two waves


def test_frames_vocoded_counts_the_generator_calls(grouped):
    """Under recording, each `tts.vocode` span counts the rows x frames of
    its generator calls as `frames_vocoded`; `tts.collect` counts the
    frames kept."""
    profiling.clear()
    with _generator_calls() as calls, profiling.recording():
        pipe = grouped["pipe"]
        waves = pipe.tts(GROUPED, batch_size=4, denoise=0.005)
    spans = profiling.recorded()
    profiling.clear()
    vocoded = sum(s.counts.get("frames_vocoded", 0) for s in spans
                  if s.name == "tts.vocode")
    kept = sum(s.counts.get("frames_kept", 0) for s in spans
               if s.name == "tts.collect")
    assert vocoded == sum(b * f for b, f in calls) > 0
    assert kept == sum(len(w) for w in waves) // 256 < vocoded


def _cost(groups):
    return sum(len(rows) * frames + hifigan.VOCODE_CALL_FRAMES
               for rows, frames in groups)


def _contiguous_cuts(lens, bucket):
    """Every cut of the rows, ordered by frames, into contiguous runs."""
    order = sorted(range(len(lens)), key=lambda i: -lens[i])
    for mask in range(2 ** (len(order) - 1)):
        groups, a = [], 0
        for b in range(1, len(order) + 1):
            if b == len(order) or mask >> (b - 1) & 1:
                run = order[a:b]
                groups.append((run, min(
                    -(-(lens[run[0]] + 16) // 64) * 64, bucket)))
                a = b
        yield groups


@pytest.mark.parametrize("seed", range(6))
def test_length_groups_cover_each_row_once_at_its_length(seed):
    """Every row in one group; a group's frames hold each row's + 16, are
    at most the bucket and a multiple of 64 unless capped at it; the cut
    costs no more than any cut into contiguous runs of the rows ordered
    by length; rows of one length make one group."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    lens = rng.integers(1, 1400, n).tolist()
    bucket = port_pipeline._pick_mel_bucket(max(lens))
    groups = hifigan.length_groups(lens, bucket)
    assert sorted(i for rows, _ in groups for i in rows) == list(range(n))
    for rows, frames in groups:
        assert rows == sorted(rows)
        assert all(lens[i] + 16 <= frames or frames == bucket for i in rows)
        assert frames <= bucket
        assert frames % 64 == 0 or frames == bucket
    assert _cost(groups) == min(_cost(g)
                                for g in _contiguous_cuts(lens, bucket))
    assert hifigan.length_groups([lens[0]] * n, bucket) == [
        (list(range(n)), min(-(-(lens[0] + 16) // 64) * 64, bucket))]
