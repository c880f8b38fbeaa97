"""The port's diacritizers (Shakkala, Shakkelha) against the JAX
package's, on the CPU in f32, on the same seeded weights: class
probabilities within 1e-5 and equal strings, batched and single; the
weight converter; `load_vowelizer`; and the vowelized token ids of the
FastPitch frontend."""
import numpy as np
import pytest
import torch

import tts_arabic_torch.diacritizers as port_diac
import tts_arabic_tpu.diacritizers as jax_diac
from torch_port_weights import write_weights
from tts_arabic_torch.diacritizers.models import BiLSTM
from tts_arabic_torch.infer import FastPitchTTS as PortTTS
from tts_arabic_torch.models.convert import diacritizer_params_to_torch
from tts_arabic_torch.runtime.config import DictConfig
from tts_arabic_tpu.diacritizers.models import (_import_bilstm,
                                                _import_dense, hard_sigmoid)
from tts_arabic_tpu.infer import FastPitchTTS as JaxTTS

MODELS = ["Shakkala", "Shakkelha"]
HARAKAT = set("ًٌٍَُِّْ")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once, and OpenMP's spinning threads then
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(n=16):
    """The first n sentences of data/test_arab.txt, diacritics stripped."""
    import pathlib
    path = pathlib.Path(__file__).parent.parent / "data" / "test_arab.txt"
    out = []
    for line in path.read_text(encoding="utf-8").splitlines()[:n]:
        text = line.split('"')[3]
        out.append("".join(ch for ch in text if ch not in HARAKAT))
    return out


@pytest.fixture(scope="module")
def models():
    return {name: (getattr(jax_diac, name)(seed=0),
                   getattr(port_diac, name)(seed=0, device="cpu"))
            for name in MODELS}


def test_hard_sigmoid_matches_keras_and_jax():
    x = np.linspace(-4.0, 4.0, 161, dtype=np.float32)
    got = port_diac.hard_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(hard_sigmoid(x)))
    np.testing.assert_allclose(got, np.clip(0.2 * x + 0.5, 0.0, 1.0),
                               atol=1e-7)
    assert got[0] == 0.0 and got[-1] == 1.0


@pytest.mark.parametrize("name", MODELS)
def test_predict_matches_jax(models, name):
    """The 16-line batch and one line alone: equal strings, probabilities
    within 1e-5 of the JAX package's."""
    ref, port = models[name]
    lines = _lines()
    want, want_p = ref.predict(lines, return_probs=True)
    got, got_p = port.predict(lines, return_probs=True)
    assert got == want
    for a, b in zip(got_p, want_p):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    one, one_p = port.predict(lines[1], return_probs=True)
    ref_one, ref_p = ref.predict(lines[1], return_probs=True)
    assert one == ref_one
    np.testing.assert_allclose(one_p, ref_p, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_batched_equals_single(models, name):
    """Padded rows hold their carry: each row of the batch is the
    sentence run alone."""
    _, port = models[name]
    lines = _lines(6)
    batch, batch_p = port.predict(lines, return_probs=True)
    for line, text, p in zip(lines, batch, batch_p):
        single, single_p = port.predict(line, return_probs=True)
        assert text == single
        np.testing.assert_allclose(p, single_p, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_empty_inputs(models, name):
    ref, port = models[name]
    assert port.predict([]) == [] and port.predict([], True) == ([], [])
    assert port.predict("") == ref.predict("")


def test_bilstm_holds_its_carry_at_masked_steps():
    """A row padded at the right gives its unpadded result at every valid
    step, in both directions."""
    torch.manual_seed(0)
    lstm = BiLSTM(5, 4)
    for p in lstm.parameters():
        p.data.normal_(0.0, 0.5)
    x = torch.randn(1, 7, 5)
    alone = lstm(x, torch.ones(1, 7, dtype=torch.bool))
    padded = torch.cat([x, torch.randn(1, 3, 5)], dim=1)
    mask = torch.tensor([[True] * 7 + [False] * 3])
    got = lstm(padded, mask, port_diac.hard_sigmoid)[:, :7]
    np.testing.assert_allclose(
        got, lstm(x, torch.ones(1, 7, dtype=torch.bool),
                  port_diac.hard_sigmoid), atol=1e-6)
    assert not torch.allclose(alone, got)


@pytest.mark.parametrize("name", MODELS)
def test_converter_inverts_the_jax_importer(name):
    """diacritizer_params_to_torch writes the reference `.pth` layout: the
    JAX package's importer reads the JAX parameters back from it."""
    params = getattr(jax_diac, name)._random_params(3)
    sd = diacritizer_params_to_torch(params)
    for key, p in params.items():
        if key.startswith("lstm"):
            back = _import_bilstm(sd, key)
            for d in ("fwd", "bwd"):
                for k in ("wi", "wh", "bi", "bh"):
                    np.testing.assert_array_equal(back[d][k], p[d][k])
        elif key.startswith("dense"):
            back = _import_dense(sd, key)
            np.testing.assert_array_equal(back["w"], p["w"])
            np.testing.assert_array_equal(back["b"], p["b"])
    emb = "emb_input.weight" if name == "Shakkala" else "emb0.weight"
    np.testing.assert_array_equal(sd[emb], params["emb"])
    if name == "Shakkala":
        np.testing.assert_array_equal(sd["bn0.running_var"],
                                      params["bn0"]["var"])


def test_load_vowelizer_reads_the_configured_file(tmp_path):
    """The config's `.pth` when it exists (a torch BatchNorm's
    num_batches_tracked included), seeded weights when it does not; an
    unknown name raises."""
    params = jax_diac.Shakkala._random_params(5)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          diacritizer_params_to_torch(params).items()}
    sd["bn0.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "shakkala.pth")
    config = DictConfig(shakkala_path=str(tmp_path / "shakkala.pth"),
                        shakkelha_path=str(tmp_path / "absent.pth"))
    loaded = port_diac.load_vowelizer("shakkala", config, device="cpu")
    line = _lines(1)[0]
    assert loaded.predict(line) == jax_diac.Shakkala(
        params=params).predict(line)
    seeded = port_diac.load_vowelizer("shakkelha", config, device="cpu")
    assert seeded.predict(line) == port_diac.Shakkelha(
        seed=0, device="cpu").predict(line)
    with pytest.raises(ValueError, match="unknown vowelizer"):
        port_diac.load_vowelizer("tashkeel", config, device="cpu")


@pytest.mark.parametrize("vowelizer", ["shakkala", "shakkelha"])
def test_vowelized_token_ids_match_jax(tmp_path_factory, vowelizer):
    """FastPitchTTS(vowelizer=...): tokenize and tokenize_batch give the
    JAX package's ids, Arabic script and Buckwalter in."""
    fp, _, _ = write_weights(tmp_path_factory.mktemp("w"))
    lines = _lines(4)
    buckw = ["*ahaba Alwaladu <ilaY Almadrasapi", "kitAbu"]
    for arabic_in, texts in ((True, lines), (False, buckw)):
        ref = JaxTTS(fp, arabic_in=arabic_in, vowelizer=vowelizer)
        port = PortTTS(fp, arabic_in=arabic_in, vowelizer=vowelizer,
                       device="cpu")
        want = ref.tokenize_batch(texts)
        got = port.tokenize_batch(texts)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        assert port.tokenize(texts[0]).tolist() == \
            ref.tokenize(texts[0]).tolist()
        plain = PortTTS(fp, arabic_in=arabic_in, device="cpu")
        assert plain.tokenize(texts[0], vowelizer).tolist() == \
            got[0].tolist()
        if vowelizer == "shakkelha":  # seeded Shakkala adds no haraka
            assert got[0].tolist() != plain.tokenize(texts[0]).tolist()
