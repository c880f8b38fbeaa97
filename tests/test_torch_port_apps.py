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
    """int8 serving is refused before anything is loaded, for either model,
    in the CLI and the registry."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NotImplementedError, match=match):
        inference.main(argv)
    entry = {"name": "x", "quantize": "int8",
             "type": argv[1] if argv[0] == "--model" else "fastpitch"}
    with pytest.raises(NotImplementedError, match=match):
        server.TTSManager([entry], device="cpu")
    with pytest.raises(ValueError, match="model type"):
        server.TTSManager([{"name": "x", "type": "vocos"}], device="cpu")


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
