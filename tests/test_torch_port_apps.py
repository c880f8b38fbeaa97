"""The port's serving surface on the CPU: the HTML report and the YAML
registry reader against the JAX package's and PyYAML, a training
checkpoint of the port served by FastPitchTTS, the inference CLI, and the
HTTP server's endpoints against the pipeline's own output."""
import json
import pathlib
import threading
import urllib.error
import urllib.request
import wave as wave_mod
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

from torch_port_weights import small_fastpitch, write_weights
from tts_arabic_torch.apps import html_report as port_html
from tts_arabic_torch.apps import inference, server
from tts_arabic_torch.audio import peak_normalize
from tts_arabic_torch.infer import FastPitch2Wave, FastPitchTTS
from tts_arabic_torch.runtime import config as port_config
from tts_arabic_torch.runtime import logging as metric_logging
from tts_arabic_torch.train.steps import TrainState, make_optimizer
from tts_arabic_torch.train.trainer import Trainer
from tts_arabic_tpu.apps import html_report as jax_html
from tts_arabic_tpu.audio.io import peak_normalize as jax_peak_normalize
from tts_arabic_tpu.runtime import config as jax_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPTS = ["Sifr wAHid", "kitAbu", "*ahaba Alwaladu <ilaY Almadrasapi"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once, and OpenMP's spinning threads then
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A `states.ckpt` written by the port's Trainer (as
    `apps.train_fastpitch` writes it) and a narrow HiFi-GAN."""
    d = tmp_path_factory.mktemp("apps")
    _, voc, voc_cfg = write_weights(d)
    model = small_fastpitch(seed=3)
    # no TensorBoard writer: its import alone takes seconds
    with mock.patch.object(metric_logging, "_tb_writer", lambda d: None):
        trainer = Trainer(None, TrainState(model, make_optimizer(model)),
                          log_dir=d / "logs", checkpoint_dir=d / "ckpt",
                          net_config=model.config.to_reference_net_config(),
                          device="cpu")
    trainer.save(epoch=0, force=True)
    trainer.close()
    return dict(model=model, checkpoint=str(d / "ckpt" / "states.ckpt"),
                vocoder_sd=voc, vocoder_config=voc_cfg)


def test_html_builders_match_jax(tmp_path):
    args = [("make_sample_entry", ("كتاب <b>", "a&b.wav", "#1")),
            ("make_sample_entry", ("plain", "x.wav")),
            ("make_double_entry", ("t", "a.wav", "b.wav", "x", "y")),
            ("make_multi_entry", ("t", ["a.wav", "b.wav", "c.wav"])),
            ("make_multi_entry", ("t", ["a.wav"], ["only"]))]
    entries = []
    for fn, a in args:
        got = getattr(port_html, fn)(*a)
        assert got == getattr(jax_html, fn)(*a)
        entries.append(got)
    assert port_html.build_page(entries, "T<") == jax_html.build_page(
        entries, "T<")
    page = port_html.write_page(tmp_path / "sub" / "index.html", entries)
    assert page.read_text(encoding="utf-8") == jax_html.build_page(entries)


def test_registry_and_basic_config_readers_match_pyyaml(tmp_path):
    text = (ROOT / "app_models.yaml").read_text()
    assert port_config.parse_yaml(text) == yaml.safe_load(text)
    assert server.load_registry(ROOT / "app_models.yaml") == \
        yaml.safe_load(text)
    assert server.load_registry(tmp_path / "absent.yaml") is None
    richer = ("# two models\n- name: fp  # comment\n  type: fastpitch\n"
              "  checkpoint: 'runs/states.ckpt'\n  compute_dtype: bfloat16\n"
              "\n- name: other\n  type: tacotron2\n  quantize: int8\n"
              "  vocoder_sd: null\n")
    assert port_config.parse_yaml(richer) == yaml.safe_load(richer)
    for bad in ("- name: a\n    type: b\n", "a: 1\n- b: 2\n", "- [1, 2]\n"):
        with pytest.raises(ValueError):
            port_config.parse_yaml(bad)
    assert port_config.get_basic_config() == dict(
        jax_config.get_basic_config())
    assert port_config.DEFAULT_BASIC_CONFIG == \
        jax_config.DEFAULT_BASIC_CONFIG


VOCOS_HPARAMS = """\
# a reference Vocos config.yaml: nested block mappings
feature_extractor:
  class_path: vocos.feature_extractors.MelSpectrogramFeatures
  init_args:
    sample_rate: 24000
    n_fft: 1024
    hop_length: 256
    n_mels: 100
    padding: center
backbone:
  class_path: vocos.models.VocosBackbone
  init_args:
    input_channels: 100
    dim: 512
    intermediate_dim: 1536
    num_layers: 8
    layer_scale_init_value:
    adanorm_num_embeddings: null
head:   # the ISTFT head
  class_path: vocos.heads.ISTFTHead
  init_args:
    dim: 512
    n_fft: 1024
    hop_length: 256
    padding: 'same'
"""


def test_yaml_reader_nested_mappings_match_pyyaml(tmp_path):
    """Nested block mappings (a Vocos hparams file), as written by hand
    and by PyYAML, read as PyYAML's safe_load reads them (the flat
    configs/*.yaml: test_torch_port_data.py); what the reader does not
    take raises."""
    want = yaml.safe_load(VOCOS_HPARAMS)
    assert want["backbone"]["init_args"]["layer_scale_init_value"] is None
    assert port_config.parse_yaml(VOCOS_HPARAMS) == want
    assert port_config.parse_yaml(yaml.safe_dump(want)) == want
    path = tmp_path / "config.yaml"
    path.write_text(VOCOS_HPARAMS)
    assert port_config.load_yaml(path) == want
    for bad in ("a:\n  - 1\n", "a:\n  b: 1\n c: 2\n", "a:\n\tb: 1\n",
                "  a:\n    b: 1\n", "- a:\n    b: 1\n  c:\n   - 2\n"):
        with pytest.raises(ValueError):
            port_config.parse_yaml(bad)


def test_peak_normalize_matches_jax():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(peak_normalize(x, 0.99),
                                  jax_peak_normalize(x, 0.99))
    silence = np.zeros(10, np.float32)
    assert peak_normalize(silence) is silence
    assert peak_normalize(np.zeros(0, np.float32)).size == 0


def test_training_checkpoint_is_served(weights):
    """FastPitchTTS reads the port's own `states.ckpt`: its net_config and
    weights, and the mels of the model that was saved."""
    tts = FastPitchTTS(weights["checkpoint"], arabic_in=False, device="cpu")
    model = weights["model"]
    assert tts.config == model.config
    for key, val in model.state_dict().items():
        assert torch.equal(tts.model.state_dict()[key], val), key
    pth = FastPitchTTS(None, config=model.config, arabic_in=False,
                       device="cpu")
    pth.model.load_state_dict(model.state_dict())
    for a, b in zip(tts.ttmel(PROMPTS, batch_size=2),
                    pth.ttmel(PROMPTS, batch_size=2)):
        np.testing.assert_array_equal(a, b)
        assert a.shape[1] > 10


def test_checkpoint_takes_the_configured_vocoder(weights, monkeypatch):
    """With an acoustic checkpoint and no vocoder weights, FastPitch2Wave
    loads the basic config's vocoder when its file exists (as the JAX
    package and the reference wrappers do); a seeded pipeline does not."""
    from tts_arabic_torch.infer import pipeline
    from tts_arabic_torch.runtime.config import DictConfig
    monkeypatch.setattr(pipeline, "get_basic_config", lambda: DictConfig(
        vocoder_state_path=weights["vocoder_sd"],
        vocoder_config_path=weights["vocoder_config"]))
    pipe = FastPitch2Wave(weights["checkpoint"], device="cpu")
    sd = torch.load(weights["vocoder_sd"])["generator"]
    assert pipe.vocoder_config.upsample_initial_channel == 64
    for key, val in pipe.vocoder.state_dict().items():
        assert torch.equal(val, sd[key]), key
    seeded = FastPitch2Wave(config=weights["model"].config, device="cpu")
    assert seeded.vocoder_config.upsample_initial_channel == 512


def test_inference_cli_on_the_cpu(weights, tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(PROMPTS) + "\n\n", encoding="utf-8")
    out = tmp_path / "out"
    page = inference.main([
        "--list", str(lst), "--checkpoint", weights["checkpoint"],
        "--vocoder-sd", weights["vocoder_sd"],
        "--vocoder-config", weights["vocoder_config"], "--buckwalter",
        "--batch-size", "2", "--out-dir", str(out), "--device", "cpu"])
    assert page == out / "index.html" and "wave_0002.wav" in page.read_text()
    pipe = FastPitch2Wave(weights["checkpoint"],
                          vocoder_sd=weights["vocoder_sd"],
                          vocoder_config=weights["vocoder_config"],
                          arabic_in=False, compute_dtype=torch.bfloat16,
                          device="cpu")
    want = pipe.tts(PROMPTS, batch_size=2, denoise=0.005)
    for i, w in enumerate(want):
        with wave_mod.open(str(out / f"wave_{i:04d}.wav")) as f:
            assert f.getframerate() == 22050
            got = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        np.testing.assert_array_equal(
            got, (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16))


@pytest.mark.parametrize("argv,match", [
    (["--model", "tacotron2", "--quantize", "int8"], "Tacotron2"),
    (["--quantize", "int8"], "int8")])
def test_unported_options_raise(argv, match, monkeypatch):
    """int8 serving, refused until the int8 path was ported, now reaches
    the pipeline of either model from the CLI and the registry (which
    still need a card unless told otherwise); an unknown model type is
    refused."""
    import tts_arabic_torch.infer as infer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(argv)
    kind = argv[1] if argv[0] == "--model" else "fastpitch"
    entry = {"name": "x", "quantize": "int8", "type": kind}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.TTSManager([entry])
    built = []

    class Built(Exception):
        pass

    def recorder(cls):
        def build(*a, **kw):
            built.append(f"{cls.__name__} quantize={kw['quantize']}")
            raise Built
        return build
    for name in ("FastPitch2Wave", "Tacotron2Wave"):
        monkeypatch.setattr(infer, name, recorder(getattr(infer, name)))
    with pytest.raises(Built):
        inference.main(argv + ["--device", "cpu"])
    with pytest.raises(Built):
        server.TTSManager([entry], device="cpu")
    assert len(built) == 2 and built[0] == built[1]
    assert match in built[0] and built[0].endswith("quantize=int8")
    with pytest.raises(ValueError, match="model type"):
        server.TTSManager([{"name": "x", "type": "vocos"}], device="cpu")


@pytest.fixture(scope="module")
def int8_weights(tmp_path_factory):
    """A vocoder with a stage the int8 path claims (C = 64), and a small
    Tacotron2 whose decodes the apps build are capped (`t2_capped`)."""
    from torch_port_weights import (SMALL_TACOTRON2, write_int8_vocoder,
                                    write_tacotron2_weights)
    from tts_arabic_torch.models.tacotron2 import Tacotron2Config
    d = tmp_path_factory.mktemp("apps_int8")
    voc, voc_cfg = write_int8_vocoder(d, gain=300.0)
    t2 = write_tacotron2_weights(d, Tacotron2Config(**SMALL_TACOTRON2))
    return dict(vocoder_sd=voc, vocoder_config=voc_cfg, tacotron2=t2)


@pytest.fixture
def t2_capped(monkeypatch):
    """Every Tacotron2 decode the apps run stops at 96 steps (the seeded
    gate stays shut), the constructor's calibration decode included."""
    from tts_arabic_torch.infer import tacotron_pipeline
    init = tacotron_pipeline.Tacotron2TTS.__init__

    def capped(self, *a, **kw):
        init(self, *a, **kw)
        self.decoder_max_step = 96
    monkeypatch.setattr(tacotron_pipeline.Tacotron2TTS, "__init__", capped)


@pytest.mark.parametrize("model", ["fastpitch", "tacotron2"])
def test_inference_cli_quantize_int8(model, weights, int8_weights, t2_capped,
                                     tmp_path):
    """--quantize int8 on the CPU writes the int8 pipeline's waves (bf16
    for FastPitch, f32 for Tacotron2, as without it)."""
    from tts_arabic_torch.infer import Tacotron2Wave
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(PROMPTS[:2]) + "\n", encoding="utf-8")
    checkpoint = (weights["checkpoint"] if model == "fastpitch"
                  else int8_weights["tacotron2"])
    voc = dict(vocoder_sd=int8_weights["vocoder_sd"],
               vocoder_config=int8_weights["vocoder_config"])
    out = tmp_path / "out"
    inference.main([
        "--model", model, "--list", str(lst), "--checkpoint", checkpoint,
        "--vocoder-sd", voc["vocoder_sd"], "--vocoder-config",
        voc["vocoder_config"], "--buckwalter", "--quantize", "int8",
        "--batch-size", "2", "--out-dir", str(out), "--device", "cpu"])
    if model == "fastpitch":
        pipe = FastPitch2Wave(checkpoint, arabic_in=False, device="cpu",
                              compute_dtype=torch.bfloat16,
                              quantize="int8", **voc)
        assert len(pipe._ffn_scales) == 2
    else:
        pipe = Tacotron2Wave(checkpoint, arabic_in=False, device="cpu",
                             quantize="int8", **voc)
    assert len(pipe._int8_scales) == 18
    want = pipe.tts(PROMPTS[:2], speed=1.0, denoise=0.005, batch_size=2)
    for i, w in enumerate(want):
        with wave_mod.open(str(out / f"wave_{i:04d}.wav")) as f:
            got = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        assert len(got) >= 256
        np.testing.assert_array_equal(
            got, (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16))


def test_server_registry_quantize_int8(weights, int8_weights, t2_capped):
    """`quantize: int8` entries load calibrated int8 pipelines of both
    types; /api/tts's path and the stream serve them."""
    registry = server.parse_yaml(
        "- name: fp8\n  type: fastpitch\n  quantize: int8\n"
        "  compute_dtype: bfloat16\n"
        f"  checkpoint: {weights['checkpoint']}\n"
        f"  vocoder_sd: {int8_weights['vocoder_sd']}\n"
        f"  vocoder_config: {int8_weights['vocoder_config']}\n"
        "- name: t28\n  type: tacotron2\n  quantize: int8\n"
        f"  checkpoint: {int8_weights['tacotron2']}\n"
        f"  vocoder_sd: {int8_weights['vocoder_sd']}\n"
        f"  vocoder_config: {int8_weights['vocoder_config']}\n")
    manager = server.TTSManager(registry, device="cpu")
    (_, fp), (_, t2) = manager.models
    assert len(fp._int8_scales) == len(t2._int8_scales) == 18
    assert fp._ffn_scales is not None
    assert fp.compute_dtype == torch.bfloat16
    direct = FastPitch2Wave(weights["checkpoint"], arabic_in=False,
                            device="cpu", compute_dtype=torch.bfloat16,
                            quantize="int8",
                            vocoder_sd=int8_weights["vocoder_sd"],
                            vocoder_config=int8_weights["vocoder_config"])
    assert direct._int8_scales == fp._int8_scales
    text = PROMPTS[2]
    outputs = manager.tts(text, denoise=0.005)
    assert [o["model"] for o in outputs] == ["fp8", "t28"]
    name, rate, chunks = manager.stream(text)
    got = np.frombuffer(b"".join(chunks), np.int16)
    want = np.concatenate(list(direct.stream(text, denoise=0.005,
                                             out_int16=True)))
    assert name == "fp8" and rate == 22050
    np.testing.assert_array_equal(got, want)


def test_cli_and_server_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.main(["--list", "no/such/list.txt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.TTSManager()


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_server_endpoints(weights):
    from http.server import ThreadingHTTPServer
    manager = server.TTSManager([{
        "name": "fp-small", "type": "fastpitch",
        "checkpoint": weights["checkpoint"],
        "vocoder_sd": weights["vocoder_sd"],
        "vocoder_config": weights["vocoder_config"]}], device="cpu")
    assert manager.warmup() > 0
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                server.make_handler(manager))
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    _, model = manager.models[0]
    text = PROMPTS[2]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=30) as r:
            page = r.read().decode()
        assert "textarea" in page and "/api/tts" in page
        with _post(port, "/api/tts", {"buckw": text, "denoise": 0.0}) as r:
            data = json.loads(r.read())
        url = data["waves"][0]["url"]
        assert data["waves"][0]["model"] == "fp-small"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{url}",
                                    timeout=30) as r:
            assert r.read()[:4] == b"RIFF"

        for fmt, dtype, out in (("s16le", np.int16, True),
                                ("mulaw", np.uint8, "mulaw")):
            with _post(port, "/api/tts/stream",
                       {"buckw": text, "rate": 1.0, "denoise": 0.005,
                        "format": fmt}) as r:
                assert r.headers["X-Audio-Format"] == fmt
                assert int(r.headers["X-Sample-Rate"]) == 22050
                got = np.frombuffer(r.read(), dtype)
            want = np.concatenate(list(model.stream(text, denoise=0.005,
                                                    out_int16=out)))
            assert want.dtype == dtype and len(want) > 256
            np.testing.assert_array_equal(got, want)

        for body in ({"buckw": text, "format": "flac"},
                     {"buckw": text, "rate": "nonsense"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, "/api/tts/stream", body)
            assert e.value.code == 500 and b"error" in e.value.read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/api/nothing", {})
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
