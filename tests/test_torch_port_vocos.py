"""The port's Vocos (`vocoder/vocos.py`) against the JAX package's, on the
CPU in f32: `MelVocosModule` and its denoising bias vector, the IMDCT
heads, the ResNet backbone, `MelSpectrogramFeatures`, mdct/imdct, the
state-dict converters, `Vocos.from_hparams` on a nested YAML file, and
`FastPitch2Wave(vocoder_type="vocos")`'s tts() and stream().

The weights are seeded with numpy in the reference layout
(`torch_port_weights.py`) at CONFIG_22K's full widths (dim 512, 8 ConvNeXt
layers of 1536) and loaded by both packages; the small parts carry the JAX
package's seeded init across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_weights import (vocos_state_dict, write_vocos_weights,
                                write_weights)
from tts_arabic_torch.infer import FastPitch2Wave as PortPipe
from tts_arabic_torch.models.convert import vocos_params_to_torch
from tts_arabic_torch.vocoder import vocos as pv
from tts_arabic_tpu.infer import FastPitch2Wave as JaxPipe
from tts_arabic_tpu.models.torch_import import vocos_params_from_torch
from tts_arabic_tpu.vocoder import vocos as jv

TEXT = "bisomi {ll~ahi {lr~aHoma`ni {lr~aHiymi"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-4):
    """max |got - want| within `rel` of the reference's peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("vocos")
    fp, _, _ = write_weights(d, duration_bias=1.0)
    return dict(fp=fp, vocos=write_vocos_weights(d))


@pytest.fixture(scope="module")
def modules(weights):
    """The same MelVocos weights in both packages."""
    sd = torch.load(weights["vocos"])
    jvars = vocos_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                    num_layers=8)
    port = pv.MelVocos(sd_path=weights["vocos"], device="cpu")
    return jvars, port


def _mel(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 2
            - 4).astype(np.float32)


def test_melvocos_module_and_bias_vector_match_jax(modules):
    jvars, port = modules
    module = jv.MelVocosModule()
    bias = module.apply(jvars, method=jv.MelVocosModule.bias_vector)
    assert port.bias_vec.shape == (513, 1)
    np.testing.assert_allclose(port.bias_vec.numpy(), np.asarray(bias),
                               rtol=1e-4, atol=1e-5)
    mel = _mel((2, 53, 80), 0)
    want = module.apply(jvars, jnp.asarray(mel), bias, 0.1)
    with torch.no_grad():
        got = port.module(torch.from_numpy(mel), port.bias_vec, 0.1)
    assert got.dtype == torch.float32 and got.shape == (2, 53 * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_melvocos_wrapper_matches_jax(weights, modules):
    _, port = modules
    ref = jv.MelVocos(sd_path=weights["vocos"])
    mel = _mel((80, 40), 1)
    want = ref(mel, denoise=0.005)
    got = port(mel, denoise=0.005)
    assert got.shape == want.shape == (1, 40 * 256)
    _close(got, want)


@pytest.mark.parametrize("head", ["IMDCTSymExpHead", "IMDCTCosHead"])
@pytest.mark.parametrize("padding", ["same", "center"])
def test_imdct_heads_match_jax(head, padding):
    x = (np.random.default_rng(2).standard_normal((2, 12, 64))
         * 0.5).astype(np.float32)
    ref = getattr(jv, head)(dim=64, mdct_frame_len=128, padding=padding)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    out = variables["params"]["out"]
    port = getattr(pv, head)(dim=64, mdct_frame_len=128, padding=padding)
    port.out.load_state_dict({
        "weight": torch.from_numpy(np.asarray(out["kernel"]).T.copy()),
        "bias": torch.from_numpy(np.array(out["bias"]))})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(ref.apply(variables, jnp.asarray(x))))


def test_resnet_backbone_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 17, 80)).astype(
        np.float32)
    ref = jv.VocosResNetBackbone(input_channels=80, dim=64, num_blocks=2)
    params = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    conv = lambda p: {"weight": np.asarray(p["kernel"]).transpose(2, 1, 0),
                      "bias": np.asarray(p["bias"])}  # noqa: E731
    sd = {f"embed.{k}": v for k, v in conv(params["embed"]).items()}
    for i in range(2):
        block = params[f"resnet_{i}"]
        for d in range(3):
            for n in (1, 2):
                for k, v in conv(block[f"conv{n}_{d}"]).items():
                    sd[f"resnet.{i}.convs{n}.{d}.{k}"] = v
            sd[f"resnet.{i}.gamma.{d}"] = np.asarray(block[f"gamma_{d}"])
    port = pv.VocosResNetBackbone(input_channels=80, dim=64, num_blocks=2)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 17, 64)
    _close(got, np.asarray(ref.apply({"params": params}, jnp.asarray(x))))


@pytest.mark.parametrize("padding", ["center", "same"])
def test_mel_features_match_jax(padding):
    audio = (np.random.default_rng(4).standard_normal((2, 6000))
             * 0.3).astype(np.float32)
    ref = jv.MelSpectrogramFeatures(padding=padding)
    port = pv.MelSpectrogramFeatures(padding=padding)
    got = port(audio)
    want = np.asarray(ref(audio))
    assert got.shape == want.shape and got.shape[1] == 100
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_mdct_imdct_roundtrip_and_jax():
    x = (np.random.default_rng(5).standard_normal((2, 2048))
         * 0.3).astype(np.float32)
    for padding in ("same", "center"):
        X = pv.mdct(torch.from_numpy(x), 512, padding)
        _close(X.numpy(), np.asarray(jv.mdct(jnp.asarray(x), 512, padding)))
        y = pv.imdct(X, 512, padding).numpy()
        _close(y, np.asarray(jv.imdct(jnp.asarray(X.numpy()), 512,
                                      padding)))
        # interior reconstructs (TDAC); the edges lose half a frame
        n = min(y.shape[-1], 2048)
        np.testing.assert_allclose(y[:, 300: n - 300], x[:, 300: n - 300],
                                   atol=1e-4)
    v = torch.tensor([-5.0, -0.5, 0.0, 0.5, 5.0])
    np.testing.assert_allclose(pv.symexp(pv.symlog(v)).numpy(), v.numpy(),
                               rtol=1e-5)


def test_vocos_converters_round_trip(weights):
    sd = {k: v.numpy() for k, v in torch.load(weights["vocos"]).items()}
    back = vocos_params_to_torch(vocos_params_from_torch(sd, 8), 8)
    assert sorted(back) == sorted(k for k in sd if "istft" not in k)
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k])
    module = pv.MelVocosModule()
    assert sorted(module.state_dict()) == sorted(back)


def test_vocos_from_hparams_matches_jax(tmp_path):
    """A reference-format hparams file (nested block mappings, read by
    the port's own YAML reader) with a reference state dict, decoded by
    both; and its copy-synthesis."""
    cfg = {
        "feature_extractor": {
            "class_path":
                "vocoder.vocos.feature_extractors.MelSpectrogramFeatures",
            "init_args": {"sample_rate": 24000, "n_fft": 1024,
                          "hop_length": 256, "n_mels": 100,
                          "padding": "center"}},
        "backbone": {
            "class_path": "vocoder.vocos.models.VocosBackbone",
            "init_args": {"input_channels": 100, "dim": 64,
                          "intermediate_dim": 96, "num_layers": 2}},
        "head": {
            "class_path": "vocoder.vocos.heads.ISTFTHead",
            "init_args": {"dim": 64, "n_fft": 1024, "hop_length": 256,
                          "padding": "center"}},
    }
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    from tts_arabic_torch.runtime.config import parse_yaml
    assert parse_yaml(cfg_path.read_text()) == cfg

    seeded = pv.Vocos.from_hparams(str(cfg_path), seed=3, device="cpu")
    sd_path = tmp_path / "model.pth"
    torch.save(vocos_state_dict(seeded.module, seed=3), sd_path)
    ours = pv.Vocos.from_hparams(str(cfg_path), str(sd_path), device="cpu")
    ref = jv.Vocos.from_hparams(str(cfg_path), str(sd_path))
    feats = _mel((2, 100, 23), 6)
    got, want = ours.decode(feats), ref.decode(feats)
    assert got.shape == want.shape == (2, 22 * 256)   # "center": T - 1
    _close(got, want)
    audio = (np.random.default_rng(7).standard_normal((1, 4096))
             * 0.1).astype(np.float32)
    _close(ours(audio), ref(audio))
    assert isinstance(seeded.module.backbone, pv.VocosBackbone)


def test_vocos_from_hparams_refusals(tmp_path, monkeypatch):
    import sys
    cfg = {"feature_extractor": {"class_path": "MelSpectrogramFeatures"},
           "backbone": {"class_path": "x.VocosResNetBackbone",
                        "init_args": {"input_channels": 100, "dim": 32,
                                      "num_blocks": 1}},
           "head": {"class_path": "x.IMDCTCosHead",
                    "init_args": {"dim": 32, "mdct_frame_len": 64}}}
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    resnet = pv.Vocos.from_hparams(str(path), device="cpu")
    assert resnet.decode(_mel((1, 100, 9), 8)).shape[0] == 1
    with pytest.raises(ValueError, match="ConvNeXt"):
        pv.Vocos.from_hparams(str(path), str(path), device="cpu")
    cfg["head"]["class_path"] = "x.Unknown"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="unsupported Vocos component"):
        pv.Vocos.from_hparams(str(path), device="cpu")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        pv.Vocos.from_pretrained("charactr/vocos-mel-24khz")


@pytest.fixture(scope="module")
def pipes(weights):
    kw = dict(vocoder_sd=weights["vocos"], vocoder_type="vocos",
              arabic_in=False)
    return (JaxPipe(weights["fp"], **kw),
            PortPipe(weights["fp"], device="cpu", **kw))


def test_fastpitch_vocos_tts_matches_jax(pipes):
    ref, port = pipes
    assert port.sample_rate == 22050 and port.hop_length == 256
    _close(port.bias_spec.numpy(), np.asarray(ref.bias_spec))
    for denoise in (0.0, 0.005):
        want = ref.tts_single(TEXT, denoise=denoise)
        got = port.tts_single(TEXT, denoise=denoise)
        assert got.dtype == np.float32
        _close(got, want)
    prompts = [TEXT, "kitAbu"]
    for w, g in zip(ref.tts(prompts, batch_size=2, denoise=0.005),
                    port.tts(prompts, batch_size=2, denoise=0.005)):
        _close(g, w)


def test_fastpitch_vocos_stream_matches_jax(pipes):
    """The port's stream against JAX's (each window through the same
    head). Both differ from tts_single at the seams: the ConvNeXt stack
    sees about +-27 frames, more than stream()'s overlap of 16."""
    ref, port = pipes
    kw = dict(chunk_frames=48, denoise=0.005)
    want = list(ref.stream(TEXT, **kw))
    got = list(port.stream(TEXT, **kw))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert len(got) >= 3
    _close(np.concatenate(got), np.concatenate(want))
