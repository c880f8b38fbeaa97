"""Host-side training data of the port against the JAX package: the log-mel
frontend, the beta-binomial prior, pYIN f0, the FastPitch dataset and its
collate on a synthetic corpus (all at 1e-6), and the port's own YAML reader
against PyYAML on every config of the repo."""
import pathlib
import wave as wave_mod

import numpy as np
import pytest
import torch
import yaml

from tts_arabic_torch.align import prior as port_prior
from tts_arabic_torch.audio import io as port_io
from tts_arabic_torch.audio import mel as port_mel
from tts_arabic_torch.data import dataset as port_ds
from tts_arabic_torch.data import f0 as port_f0
from tts_arabic_torch.runtime import config as port_config
from tts_arabic_tpu.align import prior as jax_prior
from tts_arabic_tpu.audio import io as jax_io
from tts_arabic_tpu.audio import mel as jax_mel
from tts_arabic_tpu.data import dataset as jax_ds
from tts_arabic_tpu.data import f0 as jax_f0

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHONS = ["b a m a k a", "t u k a m a n i", "s a l a m u n", "k a t a b a",
         "m i n h u m", "d a r a s a t i"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _tone(rng, n, f0, sr=22050):
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _write_wav(path, sig, sr=22050):
    pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six short tone wavs, one at 16 kHz (resampled on load), a label file
    with one unknown phoneme line and one missing wav, and the f0 dict as
    `.npz` and as a torch `.pt` of tensors."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i, phon in enumerate(PHONS):
        sr = 16000 if i == 5 else 22050
        _write_wav(root / f"s{i}.wav",
                   _tone(rng, int(sr * (0.5 + 0.1 * i)), 120 + 15 * i, sr),
                   sr)
        lines.append(f'"s{i}.wav" "{phon}"')
    lines += ['"s0.wav" "b a Q9 a"', '"absent.wav" "b a"']
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    f0 = {f"s{i}.wav": (120.0 + 15 * i) * np.ones(60 + 10 * i, np.float32)
          for i in range(len(PHONS))}
    f0["s2.wav"][::7] = 0.0     # unvoiced frames stay 0 after normalizing
    np.savez(root / "pitch_dict.npz", **f0)
    torch.save({k: torch.from_numpy(v) for k, v in f0.items()},
               root / "pitch_dict.pt")
    return root


def test_log_mel_and_filterbank_match_jax():
    rng = np.random.default_rng(1)
    x = _tone(rng, 22050 // 2 + 123, 140.0)
    np.testing.assert_allclose(
        port_mel.slaney_mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
        np.asarray(jax_mel.slaney_mel_filterbank(22050, 1024, 80, 0.0,
                                                 8000.0)), **TOL)
    got = port_mel.log_mel_numpy(x)
    ref = np.asarray(jax_mel.log_mel_numpy(x))
    assert got.shape == ref.shape == (80, (len(x) + 768 - 1024) // 256 + 1)
    np.testing.assert_allclose(got, ref, **TOL)


def test_load_wav_and_resample_match_jax(corpus):
    for name, target in (("s1.wav", 22050), ("s5.wav", 22050),
                         ("s0.wav", 16000)):
        got, sr = port_io.load_wav(corpus / name, target_sr=target)
        ref, ref_sr = jax_io.load_wav(corpus / name, target_sr=target)
        assert sr == ref_sr == target
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("mel_len,text_len", [(87, 13), (412, 50),
                                              (1000, 140)])
def test_prior_matches_jax(mel_len, text_len):
    np.testing.assert_allclose(
        port_prior.beta_binomial_prior(text_len, mel_len),
        np.asarray(jax_prior.beta_binomial_prior(text_len, mel_len)), **TOL)
    got = port_prior.BetaBinomialInterpolator()(mel_len, text_len)
    ref = jax_prior.BetaBinomialInterpolator()(mel_len, text_len)
    assert got.shape == (mel_len, text_len)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("f0_a,f0_b", [(150.0, 210.0), (95.0, 320.0)])
def test_estimate_f0_matches_jax(f0_a, f0_b):
    rng = np.random.default_rng(2)
    x = np.concatenate([_tone(rng, 6000, f0_a),
                        0.01 * rng.standard_normal(3000).astype(np.float32),
                        _tone(rng, 6000, f0_b)])
    got = port_f0.estimate_f0(x, 22050)
    ref = np.asarray(jax_f0.estimate_f0(x, 22050))
    np.testing.assert_allclose(got, ref, **TOL)
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("f0_dict", ["pitch_dict.npz", "pitch_dict.pt",
                                     None])
def test_dataset_and_collate_match_jax(corpus, f0_dict):
    kw = dict(f0_dict_path=corpus / f0_dict if f0_dict else None)
    port = port_ds.ArabDatasetFastPitch(corpus / "train.txt", corpus, **kw)
    ref = jax_ds.ArabDatasetFastPitch(corpus / "train.txt", corpus, **kw)
    assert len(port) == len(ref) == len(PHONS)  # bad lines skipped alike
    for i in range(len(port)):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), err_msg=k,
                                       **TOL)

    port_dyn = port_ds.DynBatchDataset(port, max_lengths=(30, 60, 30000),
                                       batch_sizes=(3, 2, 1))
    ref_dyn = jax_ds.DynBatchDataset(ref, max_lengths=(30, 60, 30000),
                                     batch_sizes=(3, 2, 1))
    assert port_dyn.lengths == ref_dyn.lengths
    assert port_dyn.id_batches == ref_dyn.id_batches
    for i in range(len(port_dyn)):
        got = port_ds.collate_fastpitch(port_dyn[i])
        want = jax_ds.collate_fastpitch(ref_dyn[i])
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
        assert got["tokens"].shape[1] % 16 == 0
        assert got["mel_tgt"].shape[1] % 64 == 0


def test_extract_f0_dict_matches_jax(corpus):
    paths = [corpus / f"s{i}.wav" for i in (0, 3, 5)]
    got, mean, std = port_f0.extract_f0_dict(paths)
    want, ref_mean, ref_std = jax_f0.extract_f0_dict(paths)
    assert got.keys() == want.keys() == {"s0.wav", "s3.wav", "s5.wav"}
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   **TOL)
    np.testing.assert_allclose([mean, std], [ref_mean, ref_std], **TOL)
    assert 100.0 < mean < 220.0


def test_label_parsing_and_pitch_helpers_match_jax():
    line = '"a.wav" "b a m a k a"'
    assert (port_ds.parse_label_line(port_ds.DEFAULT_LABEL_PATTERN, line)
            == jax_ds.parse_label_line(jax_ds.DEFAULT_LABEL_PATTERN, line))
    with pytest.raises(ValueError):
        port_ds.parse_label_line(port_ds.DEFAULT_LABEL_PATTERN, "no quotes")
    p = np.array([0.0, 120.0, 0.0, 160.0], np.float32)
    np.testing.assert_array_equal(
        port_ds.normalize_pitch(p.copy(), 130.0, 20.0),
        jax_ds.normalize_pitch(p.copy(), 130.0, 20.0))
    e = np.array([-12.0, -3.0, -11.0, -2.0, -15.0, -14.0], np.float32)
    np.testing.assert_array_equal(port_ds.silence_keep_mask(e.copy()),
                                  jax_ds.silence_keep_mask(e.copy()))


@pytest.mark.parametrize("name", sorted(
    p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_config_reader_equals_pyyaml(name):
    text = (ROOT / "configs" / name).read_text()
    assert port_config.parse_yaml(text) == (yaml.safe_load(text) or {})
    merged = port_config.get_config(ROOT / "configs" / name)
    assert merged == {**yaml.safe_load(
        (ROOT / "configs" / "basic.yaml").read_text()),
        **(yaml.safe_load(text) or {})}


def test_config_reader_scalars_and_refusals():
    text = ("a: 1.0e-3\nb: 1e-3\nc: [1, 'x, y', \"q\\\"z\", true]  # c\n"
            "d: ''\ne: 'it''s'\nf: off\ng: ~\nh: -7\ni: []\n")
    assert port_config.parse_yaml(text) == yaml.safe_load(text)
    for bad in ("a:\n  - 1\n", "a: {b: 1}\n", "  a: 1\n"):
        with pytest.raises(ValueError):
            port_config.parse_yaml(bad)
