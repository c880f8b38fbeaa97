"""The port's offline apps against the JAX package's on the CPU:
`audio.trim_silence_db` and `apps.preprocess` (byte for byte; f0 within
the data tests' tolerance), `apps.evaluate` (copy-synthesis zeros; a
seeded FastPitch `.pth` scored like the JAX CLI scores it),
`apps.export_torch` (the JAX exporter's keys and values, strict loads),
`apps.smoke_test` and `apps.download` (a stub fetcher that copies a
seeded `.pth`; nothing is fetched)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_port_weights import (SMALL_FASTPITCH, SMALL_TACOTRON2,
                                write_tacotron2_weights, write_weights)
from tts_arabic_torch.apps import (download, evaluate, export_torch,
                                   preprocess, smoke_test)
from tts_arabic_torch.audio import trim_silence_db
from tts_arabic_torch.models.convert import fold_weight_norm, to_tensors
from tts_arabic_torch.models.fastpitch import FastPitchConfig
from tts_arabic_torch.models.tacotron2 import Tacotron2Config
from tts_arabic_torch.runtime.checkpoint import save_states
from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
from tts_arabic_tpu.apps import evaluate as jax_evaluate
from tts_arabic_tpu.apps import preprocess as jax_preprocess
from tts_arabic_tpu.audio import save_wav as jax_save_wav
from tts_arabic_tpu.audio.io import trim_silence_db as jax_trim
from tts_arabic_tpu.models import torch_export as jax_tx
from tts_arabic_tpu.models import torch_import as jax_ti
from tts_arabic_tpu.models.fastpitch import FastPitchConfig as JaxFPConfig
from tts_arabic_tpu.models.tacotron2 import Tacotron2Config as JaxT2Config
from tts_arabic_tpu.runtime.checkpoint import load_torch_state_dict
from tts_arabic_tpu.vocoder.hifigan import HiFiGANConfig as JaxHiFiConfig

F0_TOL = dict(rtol=1e-6, atol=1e-6)     # test_torch_port_data's f0 bound
# the synthesized report against the JAX CLI's on the same `.pth`: both
# decode in f32 (mels within about 1e-4 of each other, as the pipeline
# parity tests read), so each metric within 1e-3 of the JAX value's size
REPORT_REL = 1e-3


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
    d = tmp_path_factory.mktemp("offline_weights")
    fp, voc, voc_cfg = write_weights(d)
    t2 = write_tacotron2_weights(d, Tacotron2Config(**SMALL_TACOTRON2))
    return dict(fastpitch=fp, vocoder_sd=voc, vocoder_config=voc_cfg,
                tacotron2=t2, root=d)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three tone wavs at 22.05 kHz and a labels file (JAX test_apps.py's
    evaluate corpus)."""
    root = tmp_path_factory.mktemp("evalcorpus")
    wav_dir = root / "wav"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    phon = ["m aa + s a l aa m", "k ii0 f + H aa l u0 k", "d a r s"]
    lines = []
    for i, p in enumerate(phon):
        t = np.arange(int(0.7 * 22050)) / 22050.0
        w = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
             * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
             + 0.01 * rng.standard_normal(t.shape))
        jax_save_wav(wav_dir / f"utt{i}.wav", w.astype(np.float32))
        lines.append(f'"utt{i}.wav" "{p}"')
    labels = root / "labels.txt"
    labels.write_text("\n".join(lines) + "\n")
    return labels, wav_dir


def _speech_like(rng, n, sr):
    t = np.arange(n) / sr
    env = np.clip(np.sin(np.pi * t / t[-1]) * 1.5 - 0.3, 0.0, None)
    x = env * 0.4 * np.sin(2 * np.pi * 180 * t)
    x = np.concatenate([0.002 * rng.standard_normal(n // 3), x,
                        0.002 * rng.standard_normal(n // 4)])
    return x.astype(np.float32)


def test_trim_silence_equals_jax():
    rng = np.random.default_rng(1)
    x = _speech_like(rng, 30000, 22050)
    for top_db in (10.0, 23.0, 40.0):
        got, want = trim_silence_db(x, top_db), jax_trim(x, top_db)
        assert 0 < len(got) < len(x)
        assert got.tobytes() == want.tobytes()
    short = x[:1000]
    assert trim_silence_db(short).tobytes() == jax_trim(short).tobytes()
    assert len(trim_silence_db(np.zeros(5000, np.float32))) == len(
        jax_trim(np.zeros(5000, np.float32)))


def test_preprocess_audio_and_text_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    ind = tmp_path / "in"
    ind.mkdir()
    for name, sr in (("a.wav", 44100), ("b.wav", 22050), ("c.wav", 16000)):
        jax_save_wav(ind / name, _speech_like(rng, sr, sr), sr)
    preprocess.main(["audio", "--in-dir", str(ind), "--out-dir",
                     str(tmp_path / "port")])
    jax_preprocess.main(["audio", "--in-dir", str(ind), "--out-dir",
                         str(tmp_path / "jax")])
    for name in ("a.wav", "b.wav", "c.wav"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes()

    tr = tmp_path / "orth.txt"
    tr.write_text('utt1|ذَهَبَ الوَلَدُ\n"utt2" "مَرحَباً"\n\nutt3|صِفر\n'
                  "utt4|كِتابٌ جَدِيدٌ\n", encoding="utf-8")
    preprocess.main(["text", "--transcript", str(tr), "--out-dir",
                     str(tmp_path / "tp")])
    jax_preprocess.preprocess_text(tr, tmp_path / "tj")
    for split in ("train", "test"):
        for kind in ("arab", "buckw", "phon"):
            name = f"{split}_{kind}.txt"
            assert ((tmp_path / "tp" / name).read_bytes()
                    == (tmp_path / "tj" / name).read_bytes())
    assert (tmp_path / "tp" / "train_phon.txt").read_text(
        encoding="utf-8").startswith('"utt1"')


def test_extract_f0_equals_jax(corpus, tmp_path, capsys):
    _, wav_dir = corpus
    mean, std = preprocess.extract_f0(wav_dir, tmp_path / "port.npz")
    ref_mean, ref_std = jax_preprocess.extract_f0(wav_dir,
                                                  tmp_path / "jax.npz")
    np.testing.assert_allclose([mean, std], [ref_mean, ref_std], **F0_TOL)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) == [
        "utt0.wav", "utt1.wav", "utt2.wav"]
    for k in got.files:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **F0_TOL)
    assert 140.0 < mean < 240.0 and "f0_mean" in capsys.readouterr().out


def test_evaluate_copy_synthesis_gives_zeros(corpus, tmp_path):
    labels, wav_dir = corpus
    out = tmp_path / "metrics.json"
    evaluate.main(["--labels", str(labels), "--wav-dir", str(wav_dir),
                   "--copy-synthesis", "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["n_utterances"] == 3 and len(report["per_utterance"]) == 3
    agg = report["aggregate"]
    assert agg and all(np.isfinite(v) for v in agg.values())
    assert agg["mcd"] == 0.0
    for row in report["per_utterance"]:
        for k, v in row.items():
            if k == "mcd" or k.startswith(("mae_", "delta_u_")):
                assert v == 0.0, (k, v)


def test_evaluate_synthesizes_like_jax(corpus, weights, tmp_path):
    """FastPitch from a seeded `.pth`, batch 2, on the CPU: the same
    utterances, keys and finite metrics as the JAX CLI's report on the
    same `.pth`, each within REPORT_REL."""
    labels, wav_dir = corpus
    argv = ["--labels", str(labels), "--wav-dir", str(wav_dir),
            "--checkpoint", weights["fastpitch"], "--batch-size", "2",
            "--cpu"]
    evaluate.main(argv + ["--out", str(tmp_path / "port.json")])
    jax_evaluate.main(argv + ["--out", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["n_utterances"] == want["n_utterances"] == 3
    assert got["aggregate"].keys() == want["aggregate"].keys()
    assert got["aggregate"]["mcd"] > 0
    for g, w in zip(got["per_utterance"], want["per_utterance"]):
        assert g["utt"] == w["utt"] and g.keys() == w.keys()
        for k in g:
            if k != "utt":
                assert np.isfinite(g[k])
                np.testing.assert_allclose(g[k], w[k], rtol=REPORT_REL,
                                           atol=REPORT_REL, err_msg=k)


def _same_state(got: dict, want: dict, synthesized=()):
    """The same keys, shapes and dtypes; values equal except the keys the
    JAX exporter synthesizes (flax keeps no such parameter)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if not k.startswith(synthesized):
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_export_torch_fastpitch_equals_jax_exporter(weights, tmp_path):
    from tts_arabic_torch.infer import FastPitchTTS
    from tts_arabic_torch.text import symbols
    src = torch.load(weights["fastpitch"])
    cfg = FastPitchConfig(**SMALL_FASTPITCH)
    ckpt = tmp_path / "states.ckpt"
    save_states(ckpt, config={"net_config": cfg.to_reference_net_config()},
                model=src["model"])
    out = tmp_path / "fastpitch.pth"
    export_torch.main(["--model", "fastpitch", "--checkpoint", str(ckpt),
                       "--out", str(out)])
    got = torch.load(out)
    sd = load_torch_state_dict(weights["fastpitch"])
    jcfg = JaxFPConfig(**SMALL_FASTPITCH)
    want = jax_tx.fastpitch_params_to_torch(
        jax_ti.fastpitch_params_from_torch(sd, jcfg), jcfg)
    # the unused Conv2d the reference instantiates (attention.py:96): the
    # port carries the checkpoint's, the JAX exporter writes zeros
    _same_state(got["model"], want, synthesized=("attention.attn_proj",))
    assert got["config"] == jcfg.to_reference_net_config()
    assert got["symbols"] == list(symbols)
    served = FastPitchTTS(out, arabic_in=False, device="cpu")   # strict
    assert served.config == cfg


def test_export_torch_tacotron2_equals_jax_exporter(weights, tmp_path):
    from tts_arabic_torch.infer import Tacotron2TTS
    cfg = Tacotron2Config(**SMALL_TACOTRON2)
    ckpt = tmp_path / "states.ckpt"
    save_states(ckpt, config={"net_config": dataclasses.asdict(cfg)},
                model=torch.load(weights["tacotron2"])["model"])
    out = tmp_path / "tacotron2.pth"
    export_torch.main(["--model", "tacotron2", "--checkpoint", str(ckpt),
                       "--out", str(out)])
    got = torch.load(out)
    sd = load_torch_state_dict(weights["tacotron2"])
    jcfg = JaxT2Config(**SMALL_TACOTRON2)
    want = jax_tx.tacotron2_params_to_torch(
        jax_ti.tacotron2_params_from_torch(sd, jcfg), jcfg)
    _same_state(got["model"], want)
    assert got["config"]["n_symbol"] == cfg.n_symbols
    assert "prenet_dropout" not in got["config"]
    Tacotron2TTS(out, config=cfg, arabic_in=False, device="cpu")  # strict


@pytest.mark.parametrize("layout", ["legacy", "parametrizations"])
def test_export_torch_hifigan_equals_jax_exporter(weights, tmp_path,
                                                  layout):
    cfg = HiFiGANConfig.from_json(weights["vocoder_config"])
    src = torch.load(weights["vocoder_sd"])["generator"]
    ckpt = tmp_path / "states.ckpt"
    save_states(ckpt, config={"net_config": dataclasses.asdict(cfg)},
                model=src)
    out = tmp_path / "hifigan.pth"
    export_torch.main(["--model", "hifigan", "--checkpoint", str(ckpt),
                       "--out", str(out), "--weight-norm-layout", layout])
    got = torch.load(out)
    assert got.keys() == {"generator"}
    jcfg = JaxHiFiConfig.from_json(weights["vocoder_config"])
    sd = load_torch_state_dict(weights["vocoder_sd"])
    want = jax_tx.hifigan_params_to_torch(
        jax_ti.hifigan_params_from_torch(sd, jcfg), jcfg, layout=layout)
    _same_state(got["generator"], want)
    gen = Generator(cfg)
    gen.load_state_dict(to_tensors(fold_weight_norm(got["generator"])),
                        strict=True)
    for k, v in gen.state_dict().items():
        torch.testing.assert_close(v, src[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model", ["fastpitch", "tacotron2"])
def test_smoke_test_on_the_cpu(weights, tmp_path, capsys, model,
                               monkeypatch):
    argv = ["--model", model, "--checkpoint", weights[model],
            "--vocoder-sd", weights["vocoder_sd"], "--vocoder-config",
            weights["vocoder_config"], "--cpu"]
    out = tmp_path / "smoke"
    smoke_test.main(argv + ["--out-dir", str(out)])
    assert (out / "sample.wav").stat().st_size > 44
    assert (out / "index.html").exists() and (out / "mel.png").exists()
    assert "mel.png" in capsys.readouterr().out
    # where matplotlib is missing (the card), no PNG, and the line says so
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    bare = tmp_path / "bare"
    smoke_test.main(argv + ["--out-dir", str(bare)])
    assert (bare / "sample.wav").exists() and (bare / "index.html").exists()
    assert not (bare / "mel.png").exists()
    assert "no mel.png" in capsys.readouterr().out


def test_download_manifest_and_offline_verify(tmp_path, capsys):
    assert download.main([]) == 0
    out = capsys.readouterr().out
    assert "fastpitch_ar_adv.pth" in out and "shakkala" in out
    lines = []
    rc = download.run_verify(tmp_path, list(download.FILES), fetcher=None,
                             out=lines.append)
    assert rc == 0
    assert sum("skipped" in line for line in lines) == len(download.FILES)
    assert download.main(["nonsense.pth"]) == 2


def test_download_verify_with_a_stub_fetcher(weights, tmp_path):
    """The stub copies a seeded FastPitch `.pth` where the artifact goes;
    it is loaded through the port's loader and one sentence synthesized on
    the CPU. A corrupt Tacotron2 artifact fails and flips the exit
    code."""
    src = weights["root"] / "fastpitch.pth"
    fetched = []

    def fetcher(url, dest):
        assert url == download.FILES["fastpitch_ar_mse.pth"]["url"]
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(src.read_bytes())
        fetched.append(dest)

    lines = []
    rc = download.run_verify(tmp_path, ["fastpitch_ar_mse.pth"],
                             fetcher=fetcher, out=lines.append,
                             device="cpu")
    assert rc == 0 and len(fetched) == 1
    ok = next(line for line in lines if "fastpitch_ar_mse" in line)
    assert "OK" in ok and "sha256" in ok and "mel 80x" in ok

    bad = tmp_path / download.FILES["tacotron2_ar_mse.pth"]["path"]
    bad.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {"nonsense.weight": torch.zeros(2)}}, bad)
    lines = []
    rc = download.run_verify(tmp_path, ["tacotron2_ar_mse.pth"],
                             fetcher=None, out=lines.append, device="cpu")
    assert rc == 1 and any("FAIL" in line for line in lines)
