"""The port's gate control (`tts_arabic_torch/eval/gate_control.py`) on the
CPU in f32, at the JAX package's `tests/test_gate_control.py` settings:
its SMALL_MS Tacotron2 (8 speakers, 160-step cap, prenet dropout on), its
texts, targets and three dithers. The Tacotron2 weights are the JAX
package's seed-0 flax init, carried into the port by
`models.convert.tacotron2_params_to_torch`; both pipelines vocode with
one narrow seeded HiFi-GAN.

The first tests hold the port to the JAX test's assertions with the
port's own prenet masks. The last two run the JAX package's calibration
in the same module and hold the port to it, with JAX's prenet masks fed
to the port's decode (the two packages draw their masks from different
generators): the same channels and gate scale, and JAX's rewiring
replayed into the port realizing JAX's lengths exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_weights import write_weights
from tts_arabic_torch.eval import gate_control as port_gc
from tts_arabic_torch.eval import install_gate_control
from tts_arabic_torch.infer import Tacotron2Wave as PortWave
from tts_arabic_torch.models import convert
from tts_arabic_torch.models.tacotron2 import Tacotron2Config as PortConfig
from tts_arabic_tpu.eval import gate_control as jax_gc
from tts_arabic_tpu.infer import Tacotron2Wave as JaxWave
from tts_arabic_tpu.models.tacotron2 import Tacotron2Config as JaxConfig

SMALL_MS = dict(
    n_symbols=40, symbol_embedding_dim=32, encoder_embedding_dim=32,
    num_speakers=8, speaker_embedding_dim=16, decoder_rnn_dim=48,
    attention_rnn_dim=48, attention_hidden_dim=16,
    attention_location_n_filters=4, attention_location_kernel_size=7,
    prenet_dim=16, postnet_embedding_dim=32, postnet_n_convolutions=3,
    n_mels=80, decoder_max_step=160)
STEPS = 160
TEXTS = ["ذَهَبَ الوَلَدُ", "صِفر", "كِتاب جَدِيد", "شَمس"]
TARGETS = [120, 40, 90, 64]
DITHERS = (0.0, 1.0, -1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """Both packages' calibration caches in a temp dir, so no run writes
    into the checkout."""
    d = tmp_path_factory.mktemp("gate_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTS_ARABIC_TORCH_GATE_CACHE", str(d / "torch"))
        mp.setenv("TTS_ARABIC_GATE_CACHE", str(d / "jax"))
        yield d


@pytest.fixture(scope="module")
def weights(caches, tmp_path_factory):
    """The JAX pipeline (seed-0 flax Tacotron2, the narrow vocoder) and
    its pristine weights as a reference `.pth` for the port."""
    d = tmp_path_factory.mktemp("gate_weights")
    _, voc, voc_cfg = write_weights(d)
    ref = JaxWave(seed=0, config=JaxConfig(**SMALL_MS), vocoder_sd=voc,
                  vocoder_config=voc_cfg)
    ref.model.decoder_max_step = STEPS
    sd = convert.tacotron2_params_to_torch(
        jax.device_get(ref.model.variables), ref.model.config)
    pth = d / "tacotron2.pth"
    torch.save({"model": convert.to_tensors(sd), "config": SMALL_MS}, pth)
    return dict(ref=ref, pth=str(pth), vocoder_sd=voc, vocoder_config=voc_cfg)


def _port(weights, masks=None):
    pipe = PortWave(weights["pth"], vocoder_sd=weights["vocoder_sd"],
                    vocoder_config=weights["vocoder_config"],
                    config=PortConfig(**SMALL_MS), device="cpu")
    pipe.model.decoder_max_step = STEPS
    if masks is not None:
        pipe.model.model.prenet_masks = masks
    return pipe


def _decode(pipe, speakers, postprocess_mel=False):
    """The decode outputs of TEXTS in tts()'s order, rows back in TEXTS'
    order, as numpy."""
    out = port_gc.decode_in_tts_order(pipe.model, TEXTS, speakers,
                                      postprocess_mel)
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def controlled(weights):
    pipe = _port(weights)
    speakers, lengths, report = install_gate_control(
        pipe, TEXTS, TARGETS, postprocess_mel=False,
        dither_candidates=DITHERS)
    return pipe, speakers, lengths, report


def test_realized_lengths_deterministic_and_gate_stopped(controlled):
    pipe, speakers, lengths, report = controlled
    realized = _decode(pipe, speakers)["mel_lens"].astype(int)
    np.testing.assert_array_equal(realized, lengths)
    # the reachable stops are the records of each chosen trajectory, so
    # the targets are not promised; the stops must be real, varied and
    # past the onset guard
    fired = realized < STEPS
    assert fired.sum() >= 3
    assert report["cap_fallback"] <= 1
    assert len(set(realized[fired].tolist())) >= 3
    assert (realized[fired] > 16).all()
    assert report["cache"] == "miss"


def test_gate_channel_does_not_perturb_mels(controlled):
    """Speakers 4-7 get speakers 0-3's embedding with the gate channel
    zeroed: their mels over each controlled row's length equal the
    controlled decode's bit for bit."""
    pipe, speakers, _, report = controlled
    emb = pipe.model.model.speaker_embedding.weight
    with torch.no_grad():
        emb[4:8] = emb[0:4]
        emb[4:8, report["gate_channel"]] = 0.0
    ctl = _decode(pipe, speakers)
    ref = _decode(pipe, np.arange(4, 8))
    for r, L in enumerate(ctl["mel_lens"].astype(int)):
        np.testing.assert_array_equal(ctl["mel"][r, :L], ref["mel"][r, :L])
    assert (ref["mel_lens"] == STEPS).all()


def test_tts_per_utterance_speakers(controlled):
    """tts() takes the per-utterance speakers and realizes the calibrated
    lengths; each utterance also runs alone."""
    pipe, speakers, lengths, _ = controlled
    waves = pipe.tts(list(TEXTS), speaker_id=speakers,
                     batch_size=len(TEXTS), denoise=0.0,
                     postprocess_mel=False)
    hop = pipe.hop_length
    assert [len(w) // hop for w in waves] == list(lengths)
    for t, s in zip(TEXTS, speakers):
        w = pipe.tts(t, speaker_id=int(s), denoise=0.0,
                     postprocess_mel=False)
        assert len(w) and np.isfinite(w).all()


def test_tts_speaker_sequence_validation(controlled):
    with pytest.raises(ValueError):
        controlled[0].tts(list(TEXTS), speaker_id=[0, 1],
                          batch_size=len(TEXTS), postprocess_mel=False)


def test_reinstall_is_idempotent_and_cache_replays(controlled, caches):
    """A second install restores the pristine weights and replays the disk
    cache; a new calibration on the same pipeline (the EOS-postprocess
    texts, speakers 4-7) misses it."""
    pipe, speakers, lengths, _ = controlled
    spk2, len2, rep2 = install_gate_control(
        pipe, TEXTS, TARGETS, postprocess_mel=False,
        dither_candidates=DITHERS)
    assert rep2["cache"] == "hit"
    np.testing.assert_array_equal(spk2, speakers)
    np.testing.assert_array_equal(len2, lengths)
    assert len(list((caches / "torch").glob("*.json"))) == 1

    spk_pp, len_pp, rep_pp = install_gate_control(
        pipe, TEXTS, TARGETS, postprocess_mel=True, speaker_base=4,
        dither_candidates=DITHERS)
    assert rep_pp["cache"] == "miss"
    waves = pipe.tts(list(TEXTS), speaker_id=spk_pp,
                     batch_size=len(TEXTS), denoise=0.0,
                     postprocess_mel=True)
    for w, L in zip(waves, len_pp):
        assert 1 <= len(w) // pipe.hop_length <= L + 3


def test_port_seed0_init_has_no_stop_to_reach(weights):
    """The port's own seeded init (`Tacotron2Wave(seed=0)`) at these widths
    cannot be calibrated: under each dither its gate logit is largest at
    step 0 and sets no strict prefix-maximum record in [16, cap), so no
    constant offset stops a row past the onset guard and the install
    leaves every row at the cap. Hence the tests here carry JAX's init
    over, and the `cuda` test writes numpy-seeded weights."""
    pipe = PortWave(seed=0, config=PortConfig(**SMALL_MS),
                    vocoder_sd=weights["vocoder_sd"],
                    vocoder_config=weights["vocoder_config"], device="cpu")
    pipe.model.decoder_max_step = STEPS
    ctl = port_gc._Control(pipe, TEXTS, False, 0)
    ctl.cut()
    b0 = float(ctl.snapshot[port_gc._GATE_B][0])
    for d in DITHERS:
        sig = ctl.probe(d) - b0
        assert (sig.argmax(axis=1) == 0).all(), d
        assert not any(len(port_gc._records(row, 16, STEPS)) for row in sig)
    _, lengths, report = install_gate_control(
        pipe, TEXTS, TARGETS, postprocess_mel=False,
        dither_candidates=DITHERS, use_cache=False)
    assert report["n_fired"] == 0 and (lengths == STEPS).all()


# ---- against the JAX package's calibration ---------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mask_table(n_steps, batch):
    def step(t):
        r1, r2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                     t))
        shape = (batch, SMALL_MS["prenet_dim"])
        return jnp.stack([jax.random.bernoulli(r1, 0.5, shape),
                          jax.random.bernoulli(r2, 0.5, shape)])
    return np.asarray(jax.vmap(step)(jnp.arange(n_steps + 1,
                                                dtype=jnp.int32)))


def _jax_masks(n_steps, batch, device=None, generator=None):
    """JAX's prenet keep masks of steps 0..n_steps (its decode folds the
    step into PRNGKey(0) and splits the key between the two layers) in
    the port's layout [n_steps + 1, 2, batch, prenet_dim]."""
    return torch.from_numpy(_jax_mask_table(n_steps, batch).copy())


@pytest.fixture(scope="module")
def jax_calibrated(weights, caches):
    """JAX's install on its pipeline -> (lengths, report, its cache entry:
    amp, bias, w_b, dithers, deltas)."""
    import json
    _, lengths, report = jax_gc.install_gate_control(
        weights["ref"], TEXTS, TARGETS, postprocess_mel=False,
        dither_candidates=DITHERS)
    (entry,) = (caches / "jax").glob("*.json")
    return np.asarray(lengths), report, json.loads(entry.read_text())


def test_jax_masks_drive_the_port_decode(weights):
    """With JAX's masks and the same pristine weights, the port's decode of
    TEXTS follows JAX's: the precondition of the two tests below."""
    ref = weights["ref"]
    pipe = _port(weights, _jax_masks)
    tokens, _ = ref.model._prepare_tokens(list(TEXTS), None, False)
    out, _, inverse = ref.model._dispatch_infer(tokens, np.arange(4),
                                                pad_to=4)
    want = np.asarray(out["gates"], np.float32)[inverse]
    got = _decode(pipe, np.arange(4))["gates"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_calibration_matches_jax(weights, jax_calibrated):
    """The port's own calibration with JAX's masks picks JAX's channels and
    gate scale. Its lengths are printed beside JAX's, with the port's
    live gate logit at each stop where they differ."""
    want_lens, want, _ = jax_calibrated
    pipe = _port(weights, _jax_masks)
    speakers, lengths, got = install_gate_control(
        pipe, TEXTS, TARGETS, postprocess_mel=False,
        dither_candidates=DITHERS, use_cache=False)
    for key in ("gate_channel", "dither_channel", "amplify"):
        assert got[key] == want[key], key
    print(f"\nport lengths {lengths.tolist()}, JAX {want_lens.tolist()}, "
          f"dithers {got['dithers']} / {want['dithers']}")
    gates = _decode(pipe, speakers)["gates"]
    for r in np.flatnonzero(lengths != want_lens):
        steps = [int(L) - 1 for L in (lengths[r], want_lens[r])
                 if L < STEPS]
        print(f"  row {r}: port stops at {lengths[r]}, JAX at "
              f"{want_lens[r]}; port logit at "
              + ", ".join(f"step {s}: {gates[r, s]:+.3e}" for s in steps))


def test_jax_rewiring_replays_exactly(weights, jax_calibrated):
    """JAX's calibrated bias, gate scale, dithers and deltas installed on
    the port's pristine weights realize JAX's lengths exactly."""
    want_lens, _, entry = jax_calibrated
    pipe = _port(weights, _jax_masks)
    speakers, lengths = port_gc.replay_gate_control(pipe, TEXTS, entry)
    np.testing.assert_array_equal(speakers, np.arange(4))
    np.testing.assert_array_equal(lengths, want_lens)
