"""The arguments and functions the port had dropped, against the JAX
package on the CPU in f32: scan-layout FastPitch checkpoints
(`models.convert`), `Tacotron2Wave.tts_batch(pitch_mul=, pitch_add=)`,
`FastPitch.forward_train(speaker=, use_gt_pitch=, max_duration=)`,
`FastPitch.infer`'s targets and `pitch_transform`, YIN f0, the collates'
multiples, the eval steps' figure artifacts, `Trainer.fit`'s hooks,
`validate(figures=True)` and `MetricLogger.log_training`.

Inputs are made with numpy from a seed; weights cross over with
`models.convert` (JAX -> port) or the JAX package's `.pth` importer.
Every dropout is off. Tolerances: 1e-5 (relative and absolute) for model
outputs, exact for f0, collates and scalars."""
import dataclasses
import json
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train_steps import T2_CFG
from torch_port_weights import (SMALL_TACOTRON2, tacotron2_state_dict,
                                write_tacotron2_weights, write_weights)
from tts_arabic_torch.align.prior import BetaBinomialInterpolator
from tts_arabic_torch.data import dataset as port_data
from tts_arabic_torch.data import f0 as port_f0
from tts_arabic_torch.infer import Tacotron2Wave as PortT2Wave
from tts_arabic_torch.models import convert
from tts_arabic_torch.models import tacotron2 as port_t2
from tts_arabic_torch.models.fastpitch import (FastPitch as PortFastPitch,
                                               FastPitchConfig as PortCfg)
from tts_arabic_torch.runtime.logging import MetricLogger as PortLogger
from tts_arabic_torch.train import steps as port_steps
from tts_arabic_torch.train.trainer import Trainer as PortTrainer
from tts_arabic_tpu.data import dataset as jax_data
from tts_arabic_tpu.data import f0 as jax_f0
from tts_arabic_tpu.models import layers as jax_layers
from tts_arabic_tpu.models import tacotron2 as jax_t2
from tts_arabic_tpu.models.fastpitch import FastPitch, FastPitchConfig
from tts_arabic_tpu.models.torch_import import tacotron2_params_from_torch
from tts_arabic_tpu.runtime.logging import MetricLogger as JaxLogger
from tts_arabic_tpu.train import steps as jax_steps
from tts_arabic_tpu.train.trainer import Trainer as JaxTrainer

TINY = dict(d_model=32, enc_n_layers=2, dec_n_layers=2, enc_d_head=8,
            dec_d_head=8, enc_filter_size=64, dec_filter_size=64,
            dur_filter_size=16, pitch_filter_size=16, energy_filter_size=16,
            attn_channels=8, n_speakers=4)
NO_DROPOUT = {f.name: 0.0 for f in dataclasses.fields(FastPitchConfig)
              if "drop" in f.name}
TOL = dict(rtol=1e-5, atol=1e-5)
T2_NO_DROP = dict(dataclasses.asdict(T2_CFG), prenet_dropout=0.0,
                  attention_dropout=0.0, decoder_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fp_batch(seed=0, B=3, T_txt=16, T_mel=96):
    """A collated-shape FastPitch batch with ragged lengths, zero past each
    length, the beta-binomial prior, and per-row speakers."""
    rng = np.random.default_rng(seed)
    token_lens = np.array([T_txt, 11, 7][:B], np.int32)
    mel_lens = np.array([T_mel, 80, 50][:B], np.int32)
    tokens = rng.integers(1, 40, (B, T_txt)).astype(np.int32)
    mel = rng.standard_normal((B, T_mel, 80)).astype(np.float32) - 4.0
    pitch = rng.standard_normal((B, 1, T_mel)).astype(np.float32)
    pitch[:, :, ::5] = 0.0
    energy = np.abs(rng.standard_normal((B, T_mel))).astype(np.float32) * 30
    prior = np.zeros((B, T_mel, T_txt), np.float32)
    interp = BetaBinomialInterpolator()
    for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
        tokens[i, nt:] = 0
        mel[i, nm:] = 0.0
        pitch[i, :, nm:] = 0.0
        energy[i, nm:] = 0.0
        prior[i, :nm, :nt] = interp(int(nm), int(nt))
    return {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
            "mel_lens": mel_lens, "pitch_dense": pitch,
            "energy_dense": energy, "attn_prior": prior,
            "speaker": np.array([3, 0, 2][:B], np.int32)}


@pytest.fixture(scope="module")
def fastpitch():
    """JAX's 4-speaker FastPitch (every parameter made: infer, the aligner
    and the speaker path of forward_train) and the port's with the same
    weights."""
    cfg = FastPitchConfig(**TINY, **NO_DROPOUT)
    model = FastPitch(cfg)
    b = {k: jnp.asarray(v) for k, v in _fp_batch().items()}

    def init(m):
        m.infer(b["tokens"], max_frames=32)
        return m.forward_train(
            b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
            b["pitch_dense"], b["energy_dense"], b["attn_prior"],
            jnp.ones(b["tokens"].shape, jnp.float32), speaker=b["speaker"],
            deterministic=True)
    variables = jax.device_get(jax.jit(lambda key: model.init(
        key, method=init))(jax.random.PRNGKey(0)))
    port = PortFastPitch(PortCfg(**TINY, **NO_DROPOUT)).eval()
    port.load_state_dict(convert.to_tensors(convert.fastpitch_params_to_torch(
        variables, cfg)), strict=True)
    return cfg, model, variables, port


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# ---- repair: scan-layout FFT stacks ----------------------------------------

def test_stack_unstack_round_trip_and_match_jax(fastpitch):
    """The port's numpy stack/unstack equal JAX's layout and round-trip
    exactly."""
    _, _, variables, _ = fastpitch
    for name in ("encoder", "decoder"):
        tree = variables["params"][name]
        stacked = convert.stack_fft_params(tree)
        want = jax.device_get(jax_layers.stack_fft_params(tree))
        assert (jax.tree_util.tree_structure(stacked)
                == jax.tree_util.tree_structure(want))
        jax.tree_util.tree_map(np.testing.assert_array_equal, stacked, want)
        back = convert.unstack_fft_params(stacked)
        assert sorted(back) == sorted(tree)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


def test_scan_layers_checkpoint_converts(fastpitch):
    """A scan_layers=True JAX FastPitch's params, converted by the port,
    give the per-layer model's state dict (exactly) and the infer mel of
    JAX's scan_layers=False model on the same weights (within 1e-5)."""
    cfg, model, variables, port = fastpitch
    scan_cfg = dataclasses.replace(cfg, scan_layers=True)
    params = dict(variables["params"])
    params["encoder"] = jax_layers.stack_fft_params(params["encoder"])
    params["decoder"] = jax_layers.stack_fft_params(params["decoder"])
    sd = convert.fastpitch_params_to_torch({"params": params}, scan_cfg)
    want_sd = convert.fastpitch_params_to_torch(variables, cfg)
    assert sorted(sd) == sorted(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(np.asarray(sd[k]), want_sd[k], k)
    scanned = PortFastPitch(PortCfg(**TINY, **NO_DROPOUT)).eval()
    scanned.load_state_dict(convert.to_tensors(sd), strict=True)
    tokens = _fp_batch()["tokens"]
    with torch.no_grad():
        got = scanned.infer(torch.from_numpy(tokens).long(), speaker=1,
                            max_frames=64)["mel"]
    want = model.apply(variables, jnp.asarray(tokens), speaker=1,
                       max_frames=64, method=FastPitch.infer)
    _close(got, want["mel"])


# ---- repair: Tacotron2Wave.tts_batch's pitch arguments ---------------------

def test_tacotron_tts_batch_takes_and_ignores_pitch(tmp_path):
    pth = write_tacotron2_weights(tmp_path, port_t2.Tacotron2Config(
        **dict(SMALL_TACOTRON2, prenet_dropout=0.0)))
    _, voc, voc_cfg = write_weights(tmp_path)
    pipe = PortT2Wave(pth, vocoder_sd=voc, vocoder_config=voc_cfg,
                      device="cpu")
    pipe.model.decoder_max_step = 32
    texts = ["ذَهَبَ الوَلَدُ", "صِفر"]
    want = pipe.tts_batch(texts, denoise=0.003)
    got = pipe.tts_batch(texts, denoise=0.003, pitch_mul=1.3, pitch_add=0.5)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---- FastPitch's training and inference arguments --------------------------

def test_forward_train_speaker_predicted_pitch_max_duration(fastpitch):
    """Per-row speakers, the predicted pitch in the embedding and a lower
    duration clip, against JAX's forward_train."""
    cfg, model, variables, port = fastpitch
    b = _fp_batch()
    durs = np.zeros(b["tokens"].shape, np.float32)
    for i, (nt, nm) in enumerate(zip(b["token_lens"], b["mel_lens"])):
        durs[i, :nt] = np.diff(np.linspace(0, nm, nt + 1).astype(int))
    args = [b[k] for k in ("tokens", "token_lens", "mel_tgt", "mel_lens",
                           "pitch_dense", "energy_dense", "attn_prior")]
    want = model.apply(variables, *map(jnp.asarray, args), jnp.asarray(durs),
                       speaker=jnp.asarray(b["speaker"]), use_gt_pitch=False,
                       max_duration=2.5, deterministic=True,
                       method=FastPitch.forward_train)
    t = [torch.from_numpy(a) for a in args]
    t[0], t[1], t[3] = t[0].long(), t[1].long(), t[3].long()
    with torch.no_grad():
        got = port.forward_train(*t, torch.from_numpy(durs),
                                 speaker=torch.from_numpy(b["speaker"]),
                                 use_gt_pitch=False, max_duration=2.5)
    assert float(got["dur_pred"].max()) <= 2.5
    for k in ("mel_out", "dur_pred", "log_dur_pred", "pitch_pred",
              "pitch_tgt", "energy_pred", "energy_tgt", "attn_soft"):
        _close(got[k], want[k])
    # the predicted pitch is what reaches the decoder
    with torch.no_grad():
        gt = port.forward_train(*t, torch.from_numpy(durs),
                                speaker=torch.from_numpy(b["speaker"]))
    assert not torch.allclose(gt["mel_out"], got["mel_out"])


def _pitch_transform(pitch, lens, mean, std):
    """Raise the pitch by 10% in Hz (so the result depends on both stored
    statistics) and lift it by each row's length (torch or jnp
    operands)."""
    return ((1.1 * (pitch * std + mean) - mean) / std
            + 0.01 * lens[:, None, None])


@pytest.mark.parametrize("arg", ["pitch_transform", "pitch_tgt",
                                 "energy_tgt", "dur_tgt"])
def test_infer_targets_and_pitch_transform(fastpitch, arg):
    cfg, model, variables, port = fastpitch
    tokens = _fp_batch()["tokens"]
    rng = np.random.default_rng(7)
    B, T = tokens.shape
    value = {"pitch_tgt": rng.standard_normal((B, T, 1)),
             "energy_tgt": rng.random((B, T, 1)) * 3.0,
             "dur_tgt": rng.integers(0, 4, (B, T)) * (tokens > 0),
             }.get(arg)
    if value is None:
        j_kw = p_kw = {"pitch_transform": _pitch_transform}
    else:
        value = value.astype(np.float32)
        j_kw, p_kw = {arg: jnp.asarray(value)}, {arg: torch.from_numpy(value)}
    want = model.apply(variables, jnp.asarray(tokens), speaker=2,
                       max_frames=80, method=FastPitch.infer, **j_kw)
    base = model.apply(variables, jnp.asarray(tokens), speaker=2,
                       max_frames=80, method=FastPitch.infer)
    with torch.no_grad():
        got = port.infer(torch.from_numpy(tokens).long(), speaker=2,
                         max_frames=80, **p_kw)
    np.testing.assert_array_equal(got["mel_lens"].numpy(),
                                  np.asarray(want["mel_lens"]))
    keys = ["mel", "dur_pred", "pitch_pred", "energy_pred"]
    if arg == "energy_tgt":     # no energy prediction is made
        assert got["energy_pred"] is None and want["energy_pred"] is None
        keys.remove("energy_pred")
    for k in keys:
        _close(got[k], want[k])
    assert not np.allclose(np.asarray(want["mel"]), np.asarray(base["mel"]))


# ---- YIN f0 ------------------------------------------------------------------

def _tone(seed, seconds=0.6, sr=22050):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    f = 140.0 + 40.0 * t / seconds
    x = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / sr)
    x[: sr // 10] = 0.0
    return (x + 0.01 * rng.standard_normal(len(x))).astype(np.float32)


def test_yin_f0_matches_jax(tmp_path):
    x = _tone(0)
    got = port_f0.estimate_f0(x, 22050, method="yin")
    want = np.asarray(jax_f0.estimate_f0(x, 22050, method="yin"))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > len(got) // 2
    assert not np.array_equal(got, port_f0.estimate_f0(x, 22050))
    with pytest.raises(ValueError):
        port_f0.estimate_f0(x, method="crepe")
    paths = []
    for i in range(2):
        p = tmp_path / f"tone_{i}.wav"
        with wave_mod.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes((_tone(i + 1) * 32767).astype(np.int16).tobytes())
        paths.append(p)
    got, mean, std = port_f0.extract_f0_dict(paths, method="yin")
    want, ref_mean, ref_std = jax_f0.extract_f0_dict(paths, method="yin")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert (mean, std) == (ref_mean, ref_std)


# ---- the collates' multiples -------------------------------------------------

@pytest.mark.parametrize("kind", ["fastpitch", "tacotron"])
def test_collate_multiples_match_jax(kind):
    rng = np.random.default_rng(3)
    items = []
    for nt, nm in ((9, 37), (5, 21)):
        ids = rng.integers(1, 40, nt)
        mel = rng.standard_normal((80, nm)).astype(np.float32)
        if kind == "tacotron":
            items.append((ids, mel))
        else:
            items.append({"token_ids": ids, "mel": mel,
                          "pitch": rng.standard_normal((1, nm)),
                          "energy": rng.random(nm),
                          "attn_prior": rng.random((nm, nt))})
    name = f"collate_{kind}"
    got = getattr(port_data, name)(items, text_mult=4, mel_mult=8)
    want = getattr(jax_data, name)(items, text_mult=4, mel_mult=8)
    assert got["tokens"].shape == (2, 12)
    assert got["mel_tgt"].shape == (2, 40, 80)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


# ---- the eval steps' artifacts -----------------------------------------------

def test_fastpitch_eval_artifacts_match_jax(fastpitch):
    cfg, model, variables, port = fastpitch
    b = {k: v for k, v in _fp_batch().items() if k != "speaker"}
    meta_j, art_j = jax.jit(jax_steps.make_fastpitch_eval_step(model))(
        jax_steps.TrainState(params=variables["params"], opt_state=None,
                             step=0),
        {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    meta, art = port_steps.make_fastpitch_eval_step(device="cpu")(
        port_steps.TrainState(port, port_steps.make_optimizer(port)), b)
    assert sorted(art) == sorted(art_j) == ["alignment", "mel_pred",
                                            "mel_tgt"]
    for k in art_j:
        _close(art[k], art_j[k])
    _close(meta["loss"], meta_j["loss"])


def test_tacotron_eval_artifacts_match_jax():
    cfg = jax_t2.Tacotron2Config(**T2_NO_DROP)
    sd = tacotron2_state_dict(port_t2.Tacotron2Config(**T2_NO_DROP), seed=0)
    variables = tacotron2_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, cfg)
    rng = np.random.default_rng(1)
    token_lens, mel_lens = np.array([10, 7], np.int32), np.array([48, 40],
                                                                 np.int32)
    tokens = rng.integers(1, 40, (2, 10)).astype(np.int32)
    mel = rng.standard_normal((2, 48, 80)).astype(np.float32) - 4.0
    gate = np.zeros((2, 48), np.float32)
    for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
        tokens[i, nt:] = 0
        mel[i, nm:] = 0.0
        gate[i, nm - 1:] = 1.0
    b = {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
         "gate_tgt": gate, "mel_lens": mel_lens}
    meta_j, art_j = jax.jit(jax_steps.make_tacotron_eval_step(
        jax_t2.Tacotron2(cfg)))(
        jax_steps.TrainState(params=variables["params"], opt_state=None,
                             step=0, extra=variables["batch_stats"]),
        {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
    model = port_t2.Tacotron2(port_t2.Tacotron2Config(**T2_NO_DROP)).eval()
    model.load_state_dict(sd, strict=True)
    meta, art = port_steps.make_tacotron_eval_step(device="cpu")(
        port_steps.TrainState(model, port_steps.make_optimizer(model)), b)
    assert sorted(art) == sorted(art_j)
    for k in art_j:
        _close(art[k], art_j[k])
    _close(meta["loss"], meta_j["loss"])


# ---- the trainer's hooks, figures and scalars ----------------------------------

class _Events:
    """What a fit did, in order: train batches collated, validation
    batches collated, epochs ended (with the step count)."""

    def __init__(self):
        self.log = []

    def collate(self, items):
        self.log.append(("train", items[0]))
        return {"x": np.full((len(items), 2), items[0], np.float32)}

    def val_collate(self, items):
        self.log.append(("val", items[0]))
        return {"x": np.full((len(items), 2), items[0], np.float32)}

    def epoch_end(self, trainer, epoch):
        self.log.append(("end", epoch, int(np.asarray(trainer.state.step))))


def test_fit_start_epoch_and_hooks_match_jax(tmp_path):
    """fit(start_epoch=1, on_epoch_end=, val_collate_fn=) over 3 epochs:
    the same batches, validation batches and epoch ends, in the same
    order, as JAX's Trainer."""
    data, val = [[1.0], [2.0]], [[5.0]]
    kw = dict(epochs=3, start_epoch=1, log_every=100)

    ev_j = _Events()

    def j_step(state, batch, rng):
        return (state.replace(step=state.step + 1),
                {"loss": jnp.sum(batch["x"])})
    j_state = jax_steps.TrainState(params={"w": jnp.zeros(2)},
                                   opt_state={}, step=jnp.asarray(0))
    jt = JaxTrainer(j_step, j_state, log_dir=tmp_path / "jl",
                    checkpoint_dir=tmp_path / "jc")
    jt.fit(data, ev_j.collate, val_dataset=val, val_collate_fn=ev_j.
           val_collate, on_epoch_end=ev_j.epoch_end,
           eval_fn=lambda s, b, r: ({"loss": jnp.sum(b["x"])}, None), **kw)
    jt.logger.close()

    ev_p = _Events()

    def p_step(state, batch, seed):
        state.step += 1
        return {"loss": torch.tensor(float(batch["x"].sum()))}
    lin = torch.nn.Linear(2, 2)
    pt = PortTrainer(p_step, port_steps.TrainState(
        lin, torch.optim.SGD(lin.parameters(), lr=0.1)),
        log_dir=tmp_path / "pl", checkpoint_dir=tmp_path / "pc",
        device="cpu")
    pt.fit(data, ev_p.collate, val_dataset=val, val_collate_fn=ev_p.
           val_collate, on_epoch_end=ev_p.epoch_end,
           eval_fn=lambda s, b: ({"loss": torch.tensor(
               float(b["x"].sum()))}, None), **kw)
    pt.close()
    assert ev_p.log == ev_j.log
    assert [e[:2] for e in ev_p.log if e[0] == "end"] == [("end", 1),
                                                          ("end", 2)]


def test_validate_writes_the_figures(fastpitch, tmp_path):
    """validate(figures=True) draws the first sample's alignment and mels
    from the eval step's artifacts: PNGs in the log directory without
    TensorBoard; figures=False draws none."""
    pytest.importorskip("matplotlib")
    _, _, _, port = fastpitch
    b = {k: v for k, v in _fp_batch().items() if k != "speaker"}
    trainer = PortTrainer(
        lambda s, batch, seed: {}, port_steps.TrainState(
            port, port_steps.make_optimizer(port)),
        log_dir=tmp_path, checkpoint_dir=tmp_path / "ckpt", device="cpu")
    if trainer.logger._tb:
        trainer.logger._tb.close()
    trainer.logger._tb = None
    eval_fn = port_steps.make_fastpitch_eval_step(device="cpu")
    trainer.validate([None], lambda _: b, eval_fn, step=3, figures=False)
    assert not list(tmp_path.glob("*.png"))
    means = trainer.validate([None], lambda _: b, eval_fn, step=7)
    trainer.close()
    assert sorted(p.name for p in tmp_path.glob("*.png")) == [
        "val_alignment_7.png", "val_mels_7.png"]
    assert np.isfinite(means["loss"])


def test_log_training_matches_jax(tmp_path):
    """log_training's JSONL record equals JAX's (time aside);
    log_histograms writes one histogram a parameter."""
    meta = {"loss": 1.25, "mel_loss": 0.5}
    for cls, d in ((PortLogger, tmp_path / "p"), (JaxLogger, tmp_path / "j")):
        logger = cls(d)
        logger._tb = None
        logger.log_training(4, meta, grad_norm=2.0, lr=1e-4)
        logger.close()
    recs = [json.loads((tmp_path / d / "metrics.jsonl").read_text())
            for d in ("p", "j")]
    for r in recs:
        r.pop("time")
    assert recs[0] == recs[1] == {"step": 4, "train/loss": 1.25,
                                  "train/mel_loss": 0.5,
                                  "train/grad_norm": 2.0, "train/lr": 1e-4}

    class _Spy:
        names = []

        def add_histogram(self, name, values, step):
            self.names.append(name)
    logger = PortLogger(tmp_path / "h")
    logger._tb = _Spy()
    lin = torch.nn.Linear(3, 2)
    logger.log_histograms(1, lin)
    assert _Spy.names == ["params/weight", "params/bias"]
