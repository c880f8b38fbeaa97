"""FastPitch training, MSE recipe: the port's train step against the JAX
package's `make_fastpitch_train_step(model, make_optimizer(1e-4))`, in f32
on the CPU, on the tiny config of `tests/test_train_steps.py` with every
dropout rate 0 (flax's dropout is then the identity, and so is the port's).
Weights, and the JAX gradients, cross over with
`models.convert.fastpitch_params_to_torch`. Inputs are made with numpy from
a seed. Then one epoch of the port's training CLI on a synthetic corpus,
with the MSE recipe and with `--adv` (the adversarial steps themselves are
held against JAX in `tests/test_torch_port_gan.py`).

Tolerances: forward outputs 1e-4 (f32 reassociation through the layers),
loss terms 1e-5 relative, every gradient within 1e-4 of its norm, the
parameters after one and after two AdamW steps within 1e-5."""
import dataclasses
import json
import pathlib
import wave as wave_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.align.prior import BetaBinomialInterpolator
from tts_arabic_torch.models import convert
from tts_arabic_torch.models.fastpitch import (FastPitch as PortFastPitch,
                                               FastPitchConfig as PortCfg)
from tts_arabic_torch.train import losses as port_losses
from tts_arabic_torch.train import steps as port_steps
from tts_arabic_tpu.align.mas import mas_durations as jax_mas_durations
from tts_arabic_tpu.models.fastpitch import FastPitch, FastPitchConfig
from tts_arabic_tpu.train import losses as jax_losses
from tts_arabic_tpu.train.steps import (TrainState, make_fastpitch_train_step,
                                        make_optimizer)

TINY = dict(d_model=32, enc_n_layers=1, dec_n_layers=1, enc_d_head=8,
            dec_d_head=8, enc_filter_size=64, dec_filter_size=64,
            dur_filter_size=16, pitch_filter_size=16, energy_filter_size=16,
            attn_channels=8)
NO_DROPOUT = {f.name: 0.0 for f in dataclasses.fields(FastPitchConfig)
              if "drop" in f.name}
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
OUT_KEYS = ("mel_out", "dur_pred", "log_dur_pred", "dur_tgt", "pitch_pred",
            "pitch_tgt", "energy_pred", "energy_tgt", "attn_soft",
            "attn_logprob")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, B=3, T_txt=16, T_mel=128):
    """A collated-shape batch with ragged lengths: zero-padded tokens, mels
    zero past each length (the loss masks mel by value), unvoiced (0) pitch
    frames, the beta-binomial prior."""
    rng = np.random.default_rng(seed)
    token_lens = np.array([T_txt, 11, 7][:B], np.int32)
    mel_lens = np.array([T_mel, 100, 70][:B], np.int32)
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
            "energy_dense": energy, "attn_prior": prior}


def _to_torch_tree(tree, cfg):
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            convert.fastpitch_params_to_torch(tree, cfg).items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX side, each function compiled once: the initial variables,
    forward_train outputs, loss terms, gradients, and two jitted train
    steps (meta and parameters after each)."""
    cfg = FastPitchConfig(**TINY, **NO_DROPOUT)
    model = FastPitch(cfg)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = jax.jit(lambda key: model.init(
        key, b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
        b["pitch_dense"], b["energy_dense"], b["attn_prior"],
        jnp.ones(b["tokens"].shape, jnp.float32), deterministic=True,
        method=FastPitch.forward_train))(jax.random.PRNGKey(0))
    params = variables["params"]

    @jax.jit
    def fwd_and_grads(params, b):
        attn_soft, _ = model.apply({"params": params}, b["tokens"],
                                   b["mel_tgt"], b["attn_prior"],
                                   method=FastPitch.align_attention)
        hard, durs = jax_mas_durations(attn_soft, b["token_lens"],
                                       b["mel_lens"])

        def loss_fn(p):
            out = model.apply(
                {"params": p}, b["tokens"], b["token_lens"], b["mel_tgt"],
                b["mel_lens"], b["pitch_dense"], b["energy_dense"],
                b["attn_prior"], durs, deterministic=True,
                method=FastPitch.forward_train)
            loss, meta = jax_losses.fastpitch_loss(out, b)
            kl = jax_losses.attention_binarization_loss(hard,
                                                        out["attn_soft"])
            meta["kl_loss"] = kl
            return loss + kl, (out, meta, hard)

        (_, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return aux, grads

    (out, meta, hard), grads = fwd_and_grads(params, b)
    tx = make_optimizer(1e-4)
    step = jax.jit(make_fastpitch_train_step(model, tx))
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.asarray(0))
    metas, after = [], []
    for _ in range(2):
        state, m = step(state, b, jax.random.PRNGKey(0))
        metas.append(jax.device_get(m))
        after.append(_to_torch_tree(state.params, cfg))
    return dict(cfg=cfg, variables=variables, out=jax.device_get(out),
                meta=jax.device_get(meta), hard=np.asarray(hard),
                grads=_to_torch_tree(grads, cfg), metas=metas, after=after)


def _port_model(ref):
    model = PortFastPitch(PortCfg(**TINY, **NO_DROPOUT))
    model.load_state_dict(convert.to_tensors(convert.fastpitch_params_to_torch(
        ref["variables"], ref["cfg"])), strict=True)
    return model


def _port_forward(model, b):
    """The train step's forward, on CPU tensors: soft attention, plain MAS,
    forward_train, losses (as `steps.make_fastpitch_train_step` runs
    them)."""
    with torch.no_grad():
        attn_soft, _ = model.align_attention(b["tokens"], b["mel_tgt"],
                                             b["attn_prior"])
    from tts_arabic_torch.align.mas import mas_durations
    hard, durs = mas_durations(attn_soft, b["token_lens"], b["mel_lens"])
    out = model.forward_train(
        b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
        b["pitch_dense"], b["energy_dense"], b["attn_prior"], durs)
    loss, meta = port_losses.fastpitch_loss(out, b)
    meta["kl_loss"] = port_losses.attention_binarization_loss(
        hard, out["attn_soft"])
    return out, meta, hard


def test_forward_train_and_loss_terms_match_jax(ref):
    model = _port_model(ref)
    b = port_steps.batch_to_device(_batch(), "cpu")
    out, meta, hard = _port_forward(model, b)
    np.testing.assert_array_equal(hard.numpy(), ref["hard"])
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref["out"][k]), err_msg=k,
                                   **FWD_TOL)
    assert set(meta) == set(ref["meta"])
    for k, v in meta.items():
        np.testing.assert_allclose(float(v), float(ref["meta"][k]),
                                   rtol=1e-5, atol=0, err_msg=k)


def test_ctc_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(3)
    B, T_mel, T_txt = 3, 60, 12
    logprob = np.log(rng.dirichlet(np.ones(T_txt), (B, T_mel))).astype(
        np.float32)
    token_lens = np.array([12, 9, 5], np.int32)
    mel_lens = np.array([60, 41, 30], np.int32)
    f = jax.jit(jax.value_and_grad(jax_losses.attention_ctc_loss))
    ref_loss, ref_grad = f(jnp.asarray(logprob), jnp.asarray(token_lens),
                           jnp.asarray(mel_lens))
    x = torch.from_numpy(logprob).requires_grad_()
    loss = port_losses.attention_ctc_loss(
        x, torch.from_numpy(token_lens).long(),
        torch.from_numpy(mel_lens).long())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref_grad = np.asarray(ref_grad)
    err = np.abs(x.grad.numpy() - ref_grad).max()
    assert err <= 1e-4 * np.linalg.norm(ref_grad), err


def test_train_step_meta_gradients_and_two_adamw_steps_match_jax(ref):
    model = _port_model(ref)
    state = port_steps.TrainState(model, port_steps.make_optimizer(model,
                                                                    1e-4))
    step = port_steps.make_fastpitch_train_step(device="cpu")
    batch = _batch()
    params = dict(model.named_parameters())
    for i in range(2):
        meta = step(state, batch, 0)
        want = ref["metas"][i]
        assert set(meta) == set(want)
        for k, v in meta.items():
            np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                       atol=0, err_msg=f"step {i}: {k}")
        if i == 0:
            # every gradient leaf, before the update (the norm is < 1000,
            # so the clip leaves it as it is)
            assert float(meta["grad_norm"]) < 1000.0
            n_leaves = 0
            for name, p in params.items():
                if p.grad is None:      # the unused Conv2d attn_proj
                    assert name.startswith("attention.attn_proj")
                    continue
                g_ref = ref["grads"][name].numpy()
                err = np.abs(p.grad.numpy() - g_ref).max()
                assert err <= 1e-4 * max(np.linalg.norm(g_ref), 1e-12), \
                    (name, err)
                n_leaves += 1
            assert n_leaves == len(params) - 2
        # optax decays pitch_mean/pitch_std as parameters, the port keeps
        # them as buffers: the JAX value moves by lr * wd * |value| a step,
        # 0 here (both start at 0).
        # The key bias of each attention layer adds one constant to a row
        # of scores, which the softmax cancels: its gradient is rounding
        # noise (|g| ~ 1e-9) in either framework, and Adam's step
        # lr * g / (|g| + 1e-8) turns that noise into a value in [-lr, lr].
        # Those elements are held to that bound, every other one to 1e-5.
        sd = model.state_dict()
        for name, want_p in ref["after"][i].items():
            got, want_p = sd[name].numpy(), want_p.numpy()
            noise = np.zeros(got.shape, bool)
            if name.endswith("dec_attn.qkv_net.bias"):
                noise[8:16] = True      # [q | k | v], n_head * d_head = 8
                assert np.abs(ref["grads"][name].numpy()[noise]).max() < 1e-6
                assert np.abs(got - want_p)[noise].max() <= (i + 1) * 2e-4
            np.testing.assert_allclose(got[~noise], want_p[~noise], rtol=0,
                                       atol=1e-5,
                                       err_msg=f"after step {i + 1}: {name}")
    assert state.step == 2


def test_eval_step_matches_train_forward(ref):
    model = _port_model(ref)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = port_steps.TrainState(model, port_steps.make_optimizer(model))
    meta = port_steps.make_fastpitch_eval_step(device="cpu")(state, _batch())
    want = ref["meta"]
    np.testing.assert_allclose(
        float(meta["loss"]), float(want["loss"]) + float(want["kl_loss"]),
        rtol=1e-5)
    for k in ("attn_diag_mass", "attn_peak_drift", "attn_coverage"):
        assert np.isfinite(float(meta[k])), k
    # evaluation updates nothing
    assert state.step == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_alignment_diagnostics_match_jax():
    from tts_arabic_torch.eval.alignment import alignment_diagnostics
    from tts_arabic_tpu.eval import alignment_diagnostics as jax_diag
    rng = np.random.default_rng(5)
    B, T_mel, T_txt = 3, 90, 20
    logits = 2.0 * rng.standard_normal((B, T_mel, T_txt))
    frame = np.arange(T_mel)[:, None] * T_txt / T_mel
    logits -= 0.5 * (np.arange(T_txt)[None, :] - frame) ** 2
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).astype(np.float32)
    mel_lens = np.array([90, 70, 41], np.int32)
    token_lens = np.array([20, 15, 9], np.int32)
    want = jax_diag(jnp.asarray(attn), jnp.asarray(mel_lens),
                    jnp.asarray(token_lens))
    got = alignment_diagnostics(torch.from_numpy(attn),
                                torch.from_numpy(mel_lens).long(),
                                torch.from_numpy(token_lens).long())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# ---- the CLI, one epoch on CPU ---------------------------------------------

PHONS = ["b a m a k a", "t u k a m a n i", "s a l a m u n", "k a t a b a",
         "m i n h u m", "d a r a s a t i"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """As `tests/test_train_cli.py` builds one: six 0.5-1.0 s tone wavs,
    four for training and two for validation."""
    root = tmp_path_factory.mktemp("corpus")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i, phon in enumerate(PHONS):
        n = 11025 + 2048 * i
        t = np.arange(n) / 22050.0
        sig = (0.3 * np.sin(2 * np.pi * (120 + 15 * i) * t)
               + 0.05 * rng.standard_normal(n)).astype(np.float32)
        pcm = (np.clip(sig, -1, 1) * 32767).astype("<i2")
        with wave_mod.open(str(wav_dir / f"s{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(22050)
            f.writeframes(pcm.tobytes())
        lines.append(f'"s{i}.wav" "{phon}"')
    (root / "train.txt").write_text("\n".join(lines[:4]) + "\n")
    (root / "test.txt").write_text("\n".join(lines[4:]) + "\n")
    return root, wav_dir


def _write_config(root, wav_dir, tmp_path, adv=False):
    """The nawar_fp.yaml recipe (nawar_fp_adv.yaml's with `adv`) in the flat
    YAML the port reads, with the corpus's paths and one bucket of batch
    2; no f0 dict, so the dataset runs pYIN on the fly."""
    cfg = {
        "restore_model": "", "log_dir": str(tmp_path / "logs"),
        "checkpoint_dir": str(tmp_path / "ckpt"),
        "train_wavs_path": str(wav_dir),
        "train_labels": str(root / "train.txt"),
        "test_wavs_path": str(wav_dir), "test_labels": str(root / "test.txt"),
        "label_pattern": '"(?P<filename>.*)" "(?P<phonemes>.*)"',
        "f0_dict_path": "", "f0_mean": 130.05478, "f0_std": 22.86267,
        "max_lengths": [30000], "batch_sizes": [2],
        "g_lr": 1.0e-4, "g_beta1": 0.9, "g_beta2": 0.999,
        "n_save_states_iter": 100, "n_save_backup_iter": 1000, "epochs": 1,
    }
    if adv:
        cfg.update(g_beta1=0.0, g_beta2=0.99, d_lr=1.0e-4, d_beta1=0.0,
                   d_beta2=0.99, gan_loss_weight=3.0, feat_loss_weight=1.0)
    path = tmp_path / "config.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in cfg.items()))
    return path


def test_train_fastpitch_cli_one_epoch_with_validation_and_restore(
        corpus, tmp_path):
    from tts_arabic_torch.apps import train_fastpitch
    from tts_arabic_torch.train.trainer import Trainer
    root, wav_dir = corpus
    cfg = _write_config(root, wav_dir, tmp_path)
    trainer = train_fastpitch.main(["--config", str(cfg), "--device", "cpu",
                                    "--log-every", "1"])
    assert trainer.state.step == 2              # 4 utterances, batch 2
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) for r in train_rows)
    assert len(val_rows) == 1 and val_rows[0]["step"] == 2
    for k in ("val/mel_loss", "val/kl_loss", "val/attn_diag_mass",
              "val/attn_coverage"):
        assert np.isfinite(val_rows[0][k]), k
    ckpt = tmp_path / "ckpt" / "states.ckpt"
    assert ckpt.is_file()
    assert (tmp_path / "ckpt" / "states_0.ckpt").exists() is False

    # a fresh model and trainer restore the same parameters and step
    model = PortFastPitch(PortCfg())
    fresh = Trainer(port_steps.make_fastpitch_train_step(device="cpu"),
                    port_steps.TrainState(model,
                                          port_steps.make_optimizer(model)),
                    log_dir=tmp_path / "logs2",
                    checkpoint_dir=tmp_path / "ckpt", device="cpu")
    assert fresh.restore() == 2
    for (name, a), b in zip(trainer.state.model.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name
    assert model.pitch_mean.item() == pytest.approx(130.05478)
    fresh.close()


def test_train_fastpitch_adv_cli_one_epoch_with_validation_and_restore(
        corpus, tmp_path):
    """`--adv`: the critic trains beside the model for one epoch, and a
    fresh state restores the critic (`model_d`), its optimizer (`optim_d`)
    and its iteration vectors (`spectral_d`) from the checkpoint."""
    from tts_arabic_torch.apps import train_fastpitch
    from tts_arabic_torch.runtime.config import get_config
    from tts_arabic_torch.train.trainer import Trainer
    root, wav_dir = corpus
    cfg = _write_config(root, wav_dir, tmp_path, adv=True)
    trainer = train_fastpitch.main(["--config", str(cfg), "--device", "cpu",
                                    "--log-every", "1", "--adv"])
    state = trainer.state
    assert state.step == 2 and state.critic is not None
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1]
    for k in ("train/loss", "train/loss_d", "train/score", "train/fmatch"):
        assert all(np.isfinite(r[k]) for r in train_rows), k
    val_rows = [r for r in rows if "val/loss" in r]
    assert len(val_rows) == 1 and np.isfinite(val_rows[0]["val/loss"])
    st = torch.load(tmp_path / "ckpt" / "states.ckpt", weights_only=True)
    assert {"model", "optim", "model_d", "optim_d", "spectral_d"} <= set(st)
    assert "batch_stats" not in st          # FastPitch has no BatchNorm

    model = PortFastPitch(PortCfg())
    fresh_state = port_steps.TrainState(model,
                                        port_steps.make_optimizer(model))
    port_steps.add_critic(fresh_state, get_config(cfg), 99, "cpu")
    u_init = {k: v.clone() for k, v in fresh_state.spectral.items()}
    fresh = Trainer(port_steps.make_fastpitch_train_step(device="cpu"),
                    fresh_state, log_dir=tmp_path / "logs2",
                    checkpoint_dir=tmp_path / "ckpt", device="cpu")
    assert fresh.restore() == 2
    for name, v in state.critic.state_dict().items():
        assert torch.equal(v, fresh_state.critic.state_dict()[name]), name
    for k, u in state.spectral.items():
        assert torch.equal(u, fresh_state.spectral[k]), k
        assert not torch.equal(u, u_init[k]), k
    got = fresh_state.d_optimizer.state_dict()
    want = state.d_optimizer.state_dict()
    assert got["state"].keys() == want["state"].keys()
    for i, s in want["state"].items():
        assert torch.equal(s["exp_avg_sq"], got["state"][i]["exp_avg_sq"])
    assert got["param_groups"][0]["betas"] == (0.0, 0.99)
    fresh.close()
