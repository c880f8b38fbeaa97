"""Tacotron2 training: the port's train-mode forward, loss, MSE and
adversarial steps, eval step, batching and CLI against the JAX package's
(`make_tacotron_train_step(model, make_optimizer(1e-3, grad_clip=1.0),
critic, tx_d)`), in f32 on the CPU, on `tests/test_train_steps.py`'s
`T2_CFG` at T_mel = 48 (both mels shorter than a critic chunk). Weights
and the JAX gradients cross over with `models.convert`. Every dropout is
off: the config's rates go to 0, and the encoder's and postnet's
hard-coded 0.5 is turned off by patching `Tacotron2._dropout` in both
packages for the parity tests (the JAX files are not changed). A separate
test checks the port's dropout rates and scaling statistically.

Tolerances: forward outputs 1e-4, BatchNorm running statistics 1e-6, loss
terms 1e-5 relative, every gradient (after the clip at 1.0) within 1e-4
of its norm, parameters after two steps 1e-5, the critic's vectors 1e-6.
Adam's first steps are lr x sign(g) wherever |g| is far above its eps, so
an element whose reference gradient is within the gradient tolerance of 0
(and the conv biases that feed a training BatchNorm, whose gradient is
rounding noise) is held to the bound of its Adam steps, 2 x lr a step."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import corpus  # noqa: F401  (a fixture)
from test_train_steps import T2_CFG
from torch_port_weights import tacotron2_state_dict
from tts_arabic_torch.apps import train_tacotron as port_cli
from tts_arabic_torch.data import dataset as port_data
from tts_arabic_torch.models import convert
from tts_arabic_torch.models import tacotron2 as port_t2
from tts_arabic_torch.train import gan as pg
from tts_arabic_torch.train import losses as port_losses
from tts_arabic_torch.train import steps as port_steps
from tts_arabic_tpu.apps import train_tacotron as jax_cli
from tts_arabic_tpu.data import dataset as jax_data
from tts_arabic_tpu.models import tacotron2 as jax_t2
from tts_arabic_tpu.models.torch_import import tacotron2_params_from_torch
from tts_arabic_tpu.train import gan as jg
from tts_arabic_tpu.train import losses as jax_losses
from tts_arabic_tpu.train import steps as jax_steps

NO_DROP = dict(dataclasses.asdict(T2_CFG), prenet_dropout=0.0,
               attention_dropout=0.0, decoder_dropout=0.0)
LR, CLIP, CNUM, N_STEPS = 1e-3, 1.0, 8, 2
FWD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once, and the full-width CLI runs are thousands of
    small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=1, B=2, T_txt=10, T_mel=48):
    """A collated-shape batch with ragged lengths, zero past each length,
    the gate 1 from each last frame on."""
    rng = np.random.default_rng(seed)
    token_lens = np.array([T_txt, 7], np.int32)
    mel_lens = np.array([T_mel, 40], np.int32)
    tokens = rng.integers(1, 40, (B, T_txt)).astype(np.int32)
    mel = rng.standard_normal((B, T_mel, 80)).astype(np.float32) - 4.0
    gate = np.zeros((B, T_mel), np.float32)
    for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
        tokens[i, nt:] = 0
        mel[i, nm:] = 0.0
        gate[i, nm - 1:] = 1.0
    return {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
            "gate_tgt": gate, "mel_lens": mel_lens}


def _torch_tree(variables, cfg):
    return convert.to_tensors(convert.tacotron2_params_to_torch(
        jax.device_get(variables), cfg))


def _critic_to_torch(d_params, d_spectral):
    sd, spec = convert.patch_discriminator_params_to_torch(
        {"params": jax.device_get(d_params),
         "spectral": jax.device_get(d_spectral)})
    return (convert.to_tensors(sd),
            {k: torch.tensor(np.asarray(v)) for k, v in spec.items()})


def _jax_critic(critic, seed):
    """The port's seeded critic as flax variables (OIHW -> HWIO)."""
    spec = pg.init_critic(critic, seed)
    return {"params": {name: {"kernel": jnp.asarray(
                conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
                "bias": jnp.asarray(conv.bias.detach().numpy())}
                for name, conv in critic.named_children()},
            "spectral": {k: {"u": jnp.asarray(u.numpy())}
                         for k, u in spec.items()}}


@pytest.fixture(scope="module")
def ref():
    """The JAX side with the conv-block dropout patched out, each function
    compiled once, from seeded reference-layout weights
    (`torch_port_weights.tacotron2_state_dict`) and a seeded critic: the
    eval step, and for the MSE
    and the adversarial recipe the first step's gradients (with the
    train-mode forward and its BatchNorm statistics) and two steps (meta,
    parameters, statistics, critic after each)."""
    cfg = jax_t2.Tacotron2Config(**NO_DROP)
    model = jax_t2.Tacotron2(cfg)
    critic = jg.PatchDiscriminator(CNUM)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    key = jax.random.PRNGKey(0)
    out = {"cfg": cfg}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_t2.Tacotron2, "_dropout",
                   lambda self, x, rate, train: x)
        variables = jax.tree.map(jnp.asarray, tacotron2_params_from_torch(
            {k: v.numpy() for k, v in tacotron2_state_dict(
                port_t2.Tacotron2Config(**NO_DROP), seed=0).items()}, cfg))
        d_vars = _jax_critic(pg.PatchDiscriminator(CNUM), seed=1)
        out.update(variables=jax.device_get(variables),
                   d_vars=jax.device_get(d_vars))

        def forward(p, stats, rng):
            return model.apply(
                {"params": p, "batch_stats": stats}, b["tokens"],
                b["token_lens"], b["mel_tgt"], b["mel_lens"], train=True,
                rngs={"dropout": rng}, mutable=["batch_stats"])

        meta, _ = jax.jit(jax_steps.make_tacotron_eval_step(model))(
            jax_steps.TrainState(params=variables["params"], opt_state=None,
                                 step=0, extra=variables["batch_stats"]),
            b, key)
        out["eval"] = jax.device_get(meta)

        tx = jax_steps.make_optimizer(LR, grad_clip=CLIP)
        tx_d = jax_steps.make_optimizer(1e-4)
        for adv in (False, True):
            kw = dict(params=variables["params"],
                      opt_state=tx.init(variables["params"]),
                      step=jnp.asarray(0), extra=variables["batch_stats"])
            if adv:
                kw.update(d_params=d_vars["params"],
                          d_opt_state=tx_d.init(d_vars["params"]),
                          d_spectral=d_vars["spectral"])
            state = jax_steps.TrainState(**kw)

            @jax.jit
            def grads(state, adv=adv):
                """The first step's gradients, the JAX step's arithmetic
                (`steps.py:195-242`) spelled out."""
                rng_drop, rng_chunk = jax.random.split(
                    jax.random.fold_in(key, state.step))
                if adv:
                    (o, _) = forward(jax.lax.stop_gradient(state.params),
                                     state.extra, rng_drop)
                    (d_params, _, spec, fmaps_org, ids, ofx,
                     _) = jax_steps._critic_losses(
                        critic, state, b["mel_tgt"],
                        jax.lax.stop_gradient(o[1]), b["mel_lens"],
                        rng_chunk, tx_d)

                def loss_fn(p):
                    outs, mut = forward(p, state.extra, rng_drop)
                    m_out, m_post, gates, _ = outs
                    loss, _ = jax_losses.tacotron2_loss(
                        m_out, m_post, gates, b["mel_tgt"], b["gate_tgt"],
                        b["mel_lens"])
                    if adv:
                        fake = jg.normalize_mel_chunk(jg.extract_chunks(
                            m_post, ofx, ids, 128))[..., None]
                        (d2, fmaps_gen), _ = critic.apply(
                            {"params": d_params, "spectral": spec}, fake,
                            mutable=["spectral"])
                        loss = (loss + 4.0 * jnp.mean((d2 - 1.0) ** 2)
                                + jg.feature_match_loss(fmaps_gen,
                                                        fmaps_org))
                    return loss, (outs, mut)
                return jax.grad(loss_fn, has_aux=True)(state.params)

            g, (fwd, mut) = grads(state)
            if not adv:     # the train-mode forward and its statistics
                out.update(fwd=jax.device_get(fwd),
                           stats=jax.device_get(mut))
            step = jax.jit(jax_steps.make_tacotron_train_step(
                model, tx, critic if adv else None, tx_d if adv else None))
            chunks, metas, after = [], [], []
            for i in range(N_STEPS):
                _, rng_chunk = jax.random.split(jax.random.fold_in(key, i))
                ids, ofx = jg.sample_chunk_params(rng_chunk, 2, b["mel_lens"],
                                                  128)
                chunks.append((np.asarray(ids), np.asarray(ofx)))
                state, m = step(state, b, key)
                metas.append(jax.device_get(m))
                after.append(dict(
                    model=_torch_tree({"params": state.params,
                                       "batch_stats": state.extra}, cfg),
                    critic=(_critic_to_torch(state.d_params, state.d_spectral)
                            if adv else None)))
            out["mse" if not adv else "adv"] = dict(
                grads=_torch_tree({"params": g,
                                   "batch_stats": variables["batch_stats"]},
                                  cfg),
                chunks=chunks, metas=metas, after=after)
    return out


@pytest.fixture
def no_conv_dropout(monkeypatch):
    monkeypatch.setattr(port_t2.Tacotron2, "_dropout",
                        lambda self, x, rate, gen: x)


def _port_model(ref):
    model = port_t2.Tacotron2(port_t2.Tacotron2Config(**NO_DROP))
    model.load_state_dict(_torch_tree(ref["variables"], ref["cfg"]),
                          strict=True)
    return model


def _tensors(batch):
    return port_steps.batch_to_device(batch, "cpu")


def test_train_forward_and_batch_stats_match_jax(ref, no_conv_dropout):
    model = _port_model(ref)
    b = _tensors(_batch())
    got = model.forward_train(b["tokens"], b["token_lens"], b["mel_tgt"],
                              b["mel_lens"], gen=torch.Generator())
    for name, g, want in zip(("mel_out", "mel_post", "gates", "aligns"),
                             got, ref["fwd"]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(want),
                                   err_msg=name, **FWD_TOL)
    want_sd = _torch_tree({"params": ref["variables"]["params"],
                           "batch_stats": ref["stats"]["batch_stats"]},
                          ref["cfg"])
    moved = 0
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
            moved += int(not torch.equal(v, _torch_tree(
                ref["variables"], ref["cfg"])[k]))
    assert moved == 2 * (3 + T2_CFG.postnet_n_convolutions)
    # update_stats=False leaves them
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.forward_train(b["tokens"], b["token_lens"], b["mel_tgt"],
                        b["mel_lens"], update_stats=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_tacotron2_loss_matches_jax():
    rng = np.random.default_rng(5)
    B, T = 3, 40
    mel_out, mel_post, mel_tgt = (rng.standard_normal((B, T, 80)).astype(
        np.float32) for _ in range(3))
    gate = 3 * rng.standard_normal((B, T)).astype(np.float32)
    lens = np.array([40, 31, 9], np.int32)
    gate_tgt = (np.arange(T)[None] >= lens[:, None] - 1).astype(np.float32)
    args = (mel_out, mel_post, gate, mel_tgt, gate_tgt, lens)
    f = jax.jit(jax.value_and_grad(
        lambda g, *a: jax_losses.tacotron2_loss(a[0], a[1], g, *a[2:]),
        has_aux=True))
    (_, want), want_g = f(jnp.asarray(gate), jnp.asarray(mel_out),
                          jnp.asarray(mel_post), jnp.asarray(mel_tgt),
                          jnp.asarray(gate_tgt), jnp.asarray(lens))
    t = [torch.from_numpy(a) for a in args]
    t[2].requires_grad_()
    t[5] = t[5].long()
    loss, meta = port_losses.tacotron2_loss(*t)
    loss.backward()
    assert set(meta) == set(want)
    for k, v in meta.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(t[2].grad.numpy(), np.asarray(want_g),
                               rtol=0, atol=1e-7)


def _port_state(ref, adv):
    model = _port_model(ref)
    state = port_steps.TrainState(
        model, port_steps.make_optimizer(model, LR, grad_clip=CLIP))
    if adv:
        critic = pg.PatchDiscriminator(CNUM)
        sd, spec = _critic_to_torch(ref["d_vars"]["params"],
                                    ref["d_vars"]["spectral"])
        critic.load_state_dict(sd, strict=True)
        state.critic, state.spectral = critic, spec
        state.d_optimizer = port_steps.make_optimizer(critic, 1e-4)
    return state


# The bias of a conv that feeds a BatchNorm in training adds a constant
# that the batch mean takes out again: its gradient is rounding noise
# (|g| ~ 1e-8) in either framework, and Adam's step lr * g / (|g| + 1e-8)
# turns that noise into a value in [-lr, lr]. Those biases are held to
# that bound, and the following BatchNorm's running mean, which takes 0.1
# of the bias into its batch mean, to 0.1 x the biases' difference before
# the step (1e-6 about it). The running statistics of the two steps are
# held to 1e-6 absolute and relative (values up to ~9 after two updates).
NOISE_BIASES = tuple(
    f"{stack}.convolutions.{i}.0.conv.bias"
    for stack, n in (("encoder", T2_CFG.encoder_n_convolutions),
                     ("postnet", T2_CFG.postnet_n_convolutions))
    for i in range(n))


def _noise_bn(name):
    """The running mean that follows a noise bias."""
    return name.replace(".0.conv.bias", ".1.running_mean")


@pytest.mark.parametrize("recipe", ["mse", "adv"])
def test_train_steps_match_jax(ref, recipe, no_conv_dropout):
    want_run = ref[recipe]
    state = _port_state(ref, recipe == "adv")
    step = port_steps.make_tacotron_train_step(device="cpu")
    params = dict(state.model.named_parameters())
    bias_diff = {n: 0.0 for n in NOISE_BIASES}
    for i in range(N_STEPS):
        meta = step(state, _batch(), 0, chunks=want_run["chunks"][i])
        want = want_run["metas"][i]
        assert set(meta) == set(want)
        for k, v in meta.items():
            np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                       atol=0, err_msg=f"step {i}: {k}")
        if i == 0:
            # the clip at 1.0 scaled every gradient by 1 / |g|
            norm = float(meta["grad_norm"])
            assert norm > CLIP
            for name, p in params.items():
                g_ref = want_run["grads"][name].numpy() / norm
                if name in NOISE_BIASES:
                    assert np.abs(g_ref).max() < 1e-6, name
                    assert np.abs(p.grad.numpy()).max() < 1e-6, name
                    continue
                err = np.abs(p.grad.numpy() - g_ref).max()
                assert err <= 1e-4 * max(np.linalg.norm(g_ref), 1e-12), \
                    (name, err)
        sd = state.model.state_dict()
        after = want_run["after"][i]["model"]
        for name, want_p in after.items():
            got, want_p = sd[name].numpy(), want_p.numpy()
            if name.endswith("num_batches_tracked"):
                assert int(got) == i + 1
                continue
            if name in NOISE_BIASES:
                assert np.abs(got - want_p).max() <= (i + 1) * 2 * LR, name
                continue
            if "running" in name:
                if name in map(_noise_bn, NOISE_BIASES):
                    got = got - 0.1 * bias_diff[name.replace(
                        ".1.running_mean", ".0.conv.bias")]
                np.testing.assert_allclose(
                    got, want_p, rtol=1e-6, atol=1e-6,
                    err_msg=f"after step {i + 1}: {name}")
                continue
            # an element whose gradient lies within the gradient tolerance
            # of zero may take the other sign, which Adam turns into a step
            # of up to lr the other way
            g0 = want_run["grads"][name].numpy()
            near0 = np.abs(g0) < 1e-4 * np.linalg.norm(g0)
            assert np.abs(got - want_p)[near0].max(initial=0) <= \
                (i + 1) * 2 * LR, name
            np.testing.assert_allclose(got[~near0], want_p[~near0], rtol=0,
                                       atol=1e-5,
                                       err_msg=f"after step {i + 1}: {name}")
        bias_diff = {n: sd[n].numpy() - after[n].numpy()
                     for n in NOISE_BIASES}
        if recipe == "adv":
            d_sd, d_spec = want_run["after"][i]["critic"]
            for name, want_p in d_sd.items():
                np.testing.assert_allclose(
                    state.critic.state_dict()[name].numpy(), want_p.numpy(),
                    rtol=0, atol=1e-5, err_msg=f"critic {i + 1}: {name}")
            for k, u in d_spec.items():
                np.testing.assert_allclose(state.spectral[k].numpy(),
                                           u.numpy(), rtol=0, atol=1e-6,
                                           err_msg=k)
            assert {"score", "fmatch", "loss_d"} <= set(meta)
    assert state.step == N_STEPS


def test_eval_step_matches_jax(ref, no_conv_dropout):
    model = _port_model(ref)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = port_steps.TrainState(model, port_steps.make_optimizer(model))
    meta, _ = port_steps.make_tacotron_eval_step(device="cpu")(state,
                                                                _batch())
    assert set(meta) == set(ref["eval"])
    for k, v in meta.items():
        np.testing.assert_allclose(float(v), float(ref["eval"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_collate_tacotron_matches_jax():
    rng = np.random.default_rng(0)
    items = [(rng.integers(1, 40, n).astype(np.int32),
              rng.standard_normal((80, m)).astype(np.float32))
             for n, m in ((7, 70), (19, 130), (3, 5))]
    got, want = port_data.collate_tacotron(items), \
        jax_data.collate_tacotron(items)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["mel_tgt"].shape == (3, 192, 80)


def test_weighted_sampler_matches_jax(tmp_path):
    w = np.array([1.0, 1.0, 1.0, 5.0, 0.5, 2.0])
    got = port_data.WeightedSampler(w, seed=3)
    want = jax_data.WeightedSampler(w, seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(got.sample(), want.sample())
    np.save(tmp_path / "w.npy", w)
    torch.save(torch.tensor(w), tmp_path / "w.pt")
    for name in ("w.npy", "w.pt"):
        s = port_data.WeightedSampler.from_file(tmp_path / name, seed=1)
        np.testing.assert_allclose(s.weights, w / w.sum())
        assert sorted(s.sample()) == list(range(6))


class _DS:
    """Items of ascending mel length: item i has 10 + 400 i frames."""

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return (np.full(3, i, np.int32),
                np.zeros((80, 10 + 400 * i), np.float32))


@pytest.mark.parametrize("sampled", [False, True])
def test_batched_view_matches_jax(sampled):
    """The same order (shuffle or sampler), batch cut and truncation of
    batches over max_frames, epoch after epoch."""
    views = []
    for pkg, cli in ((port_data, port_cli), (jax_data, jax_cli)):
        sampler = (pkg.WeightedSampler(np.arange(1.0, 8.0), seed=2)
                   if sampled else None)
        views.append(cli._BatchedView(_DS(), 3, max_frames=1500,
                                      truncated=2, sampler=sampler))
    got, want = views
    assert len(got) == len(want) == 3
    for _ in range(3):
        for i in range(len(want)):
            g, w = got[i], want[i]
            assert [int(t[0]) for t, _ in g] == [int(t[0]) for t, _ in w]
        got.shuffle()
        want.shuffle()
    assert any(len(got[i]) == 2 for i in range(3))    # a truncated batch


def test_dropout_rates_and_scaling():
    """With the dropouts on: each conv block's output loses half its
    values and the rest double; the prenet keeps each value with p 0.5,
    the LSTMs' outputs with p 0.9 (scaled by 1 / 0.9); the masks come
    from the generator, so a seed replays them."""
    cfg = port_t2.Tacotron2Config(**dataclasses.asdict(T2_CFG))
    model = port_t2.init_tacotron2(port_t2.Tacotron2(cfg), 0)
    b = _tensors(_batch(T_mel=64))
    seen = []
    orig = port_t2.Tacotron2._dropout

    def spy(self, x, rate, gen):
        y = orig(self, x, rate, gen)
        seen.append((rate, x.detach(), y.detach()))
        return y

    args = (b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_t2.Tacotron2, "_dropout", spy)
        outs = [model.forward_train(*args, gen=torch.Generator().manual_seed(
            s), update_stats=False)[1] for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert len(seen) == 3 * (3 + cfg.postnet_n_convolutions)
    x = torch.cat([x.flatten() for _, x, _ in seen])
    y = torch.cat([y.flatten() for _, _, y in seen])
    assert all(rate == 0.5 for rate, _, _ in seen)
    nz = x != 0
    kept = (y[nz] != 0).float().mean()
    assert abs(float(kept) - 0.5) < 0.01, float(kept)
    torch.testing.assert_close(y[nz & (y != 0)], 2 * x[nz & (y != 0)])

    gen = torch.Generator().manual_seed(0)
    att, dec = model._lstm_keep_masks(2000, 4, "cpu", gen)
    for keep, dim in ((att, cfg.attention_rnn_dim),
                      (dec, cfg.decoder_rnn_dim)):
        assert keep.shape == (2000, 4, dim)
        assert abs(float(keep.float().mean()) - 0.9) < 0.005
    pre = model.prenet_masks(2000, 4, "cpu", gen)
    assert abs(float(pre.float().mean()) - 0.5) < 0.005

    # the LSTM masks: a step's output is zero where the mask drops it and
    # scaled by 1 / 0.9 elsewhere
    w = model.decoder_weights(torch.float32)
    enc = model.encode_infer(b["tokens"], b["token_lens"])
    state = model.init_decode_carry(enc["memory"])
    pre_out = torch.randn(2, cfg.prenet_dim)
    plain = model._decode_step(state, pre_out, enc, w)[0]
    keep = (att[0, :2], dec[0, :2])
    dropped = model._decode_step(state, pre_out, enc, w, keep)[0]
    torch.testing.assert_close(dropped["attn_h"],
                               torch.where(keep[0], plain["attn_h"] / 0.9,
                                           0.0))
    assert torch.equal(dropped["attn_c"], plain["attn_c"])


def _write_config(root, wav_dir, tmp_path):
    """configs/nawar_tc2(_adv).yaml in the flat YAML the port reads, with
    the corpus's paths, batch 2 and a 200-step decoder cap."""
    cfg = {
        "restore_model": "", "log_dir": str(tmp_path / "logs"),
        "checkpoint_dir": str(tmp_path / "ckpt"),
        "train_wavs_path": str(wav_dir),
        "train_labels": str(root / "train.txt"),
        "test_wavs_path": str(wav_dir), "test_labels": str(root / "test.txt"),
        "label_pattern": '"(?P<filename>.*)" "(?P<phonemes>.*)"',
        "max_frames": 2000, "truncated_batch_size": 6, "batch_size": 2,
        "decoder_max_step": 200, "grad_clip_thresh": 1.0,
        "cache_dataset": False, "g_lr": 1.0e-4, "g_beta1": 0.0,
        "g_beta2": 0.99, "d_lr": 1.0e-4, "d_beta1": 0.0, "d_beta2": 0.99,
        "gan_loss_weight": 4.0, "feat_loss_weight": 1.0,
        "n_save_states_iter": 10, "n_save_backup_iter": 1000, "epochs": 1,
    }
    path = tmp_path / "config.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in cfg.items()))
    return path


@pytest.mark.parametrize("adv", [False, True], ids=["mse", "adv"])
def test_train_tacotron_cli_one_epoch_with_validation_and_restore(
        corpus, tmp_path, adv):  # noqa: F811
    from tts_arabic_torch.runtime.config import get_config
    from tts_arabic_torch.train.trainer import Trainer
    root, wav_dir = corpus
    cfg = _write_config(root, wav_dir, tmp_path)
    trainer = port_cli.main(["--config", str(cfg), "--device", "cpu",
                             "--log-every", "1"] + (["--adv"] if adv else []))
    assert trainer.state.step == 2              # 4 utterances, batch 2
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    val_rows = [r for r in rows if "val/loss" in r]
    assert [r["step"] for r in train_rows] == [0, 1]
    keys = ["train/loss", "train/gate_loss", "train/grad_norm"] + (
        ["train/loss_d", "train/score", "train/fmatch"] if adv else [])
    assert all(np.isfinite(r[k]) for r in train_rows for k in keys)
    assert len(val_rows) == 1 and val_rows[0]["step"] == 2
    for k in ("val/mel_loss", "val/post_mel_loss", "val/attn_diag_mass"):
        assert np.isfinite(val_rows[0][k]), k
    st = torch.load(tmp_path / "ckpt" / "states.ckpt", weights_only=True)
    want_keys = {"model", "optim", "batch_stats"} | (
        {"model_d", "optim_d", "spectral_d"} if adv else set())
    assert want_keys <= set(st) and st["step"] == 2
    assert all(k.startswith(("encoder.convolutions", "postnet.convolutions"))
               for k in st["batch_stats"])

    # a fresh state restores the parameters, the statistics, the optimizer
    # and, for --adv, the critic, its optimizer and its vectors
    model = port_t2.Tacotron2(port_t2.Tacotron2Config())
    state = port_steps.TrainState(model, port_steps.make_optimizer(model))
    if adv:
        port_steps.add_critic(state, get_config(cfg), 99, "cpu")
    fresh = Trainer(port_steps.make_tacotron_train_step(device="cpu"), state,
                    log_dir=tmp_path / "logs2",
                    checkpoint_dir=tmp_path / "ckpt", device="cpu")
    assert fresh.restore() == 2
    old = trainer.state
    for name, v in old.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[name]), name
    assert int(model.encoder.convolutions[0][1].num_batches_tracked) == 2
    moments = [s["exp_avg"] for s in old.optimizer.state_dict()[
        "state"].values()]
    assert all(torch.equal(a, s["exp_avg"]) for a, s in zip(
        moments, state.optimizer.state_dict()["state"].values()))
    if adv:
        for name, v in old.critic.state_dict().items():
            assert torch.equal(v, state.critic.state_dict()[name]), name
        for k, u in old.spectral.items():
            assert torch.equal(u, state.spectral[k]), k
        assert (state.d_optimizer.state_dict()["state"].keys()
                == old.d_optimizer.state_dict()["state"].keys())
    fresh.close()
