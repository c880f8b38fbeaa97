"""The adversarial recipe: the port's critic, mel chunks and adversarial
FastPitch step against the JAX package's (`train/gan.py`,
`make_fastpitch_train_step(model, tx, critic, tx_d)`), in f32 on the CPU.
Weights cross over with `models.convert` (`patch_discriminator_params_to_
torch` for the critic, HWIO -> OIHW, its `u` vectors as they are). The
FastPitch side is `tests/test_torch_port_train.py`'s tiny config with every
dropout rate 0, and JAX's chunk ids and offsets are injected into the
port's step (the two draw them from different generators).

Tolerances: critic scores and feature maps 1e-5, the iteration vectors
1e-6, the critic's gradients within 1e-4 of their norm; the adversarial
step's loss terms 1e-5 relative, every generator gradient within 1e-4 of
its norm, generator and critic parameters after two steps within 1e-5, the
vectors within 1e-6. Chunk gathers are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train import NO_DROPOUT, TINY, _batch, _to_torch_tree
from tts_arabic_torch.models import convert
from tts_arabic_torch.models.fastpitch import (FastPitch as PortFastPitch,
                                               FastPitchConfig as PortCfg)
from tts_arabic_torch.train import gan as pg
from tts_arabic_torch.train import steps as port_steps
from tts_arabic_tpu.align.mas import mas_durations as jax_mas_durations
from tts_arabic_tpu.models.fastpitch import FastPitch, FastPitchConfig
from tts_arabic_tpu.train import gan as jg
from tts_arabic_tpu.train import losses as jax_losses
from tts_arabic_tpu.train.steps import (CHUNK_LEN, TrainState, _critic_losses,
                                        make_fastpitch_train_step,
                                        make_optimizer)

CNUM = 8
N_STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _critic_to_torch(d_params, d_spectral):
    sd, spec = convert.patch_discriminator_params_to_torch(
        {"params": jax.device_get(d_params),
         "spectral": jax.device_get(d_spectral)})
    return (convert.to_tensors(sd),
            {k: torch.tensor(np.asarray(v)) for k, v in spec.items()})


def _jax_chunks(rng, step, mel_lens):
    """The JAX step's chunk ids and offsets at `step`."""
    _, rng_chunk = jax.random.split(jax.random.fold_in(rng, step))
    ids, ofx = jg.sample_chunk_params(rng_chunk, len(mel_lens),
                                      jnp.asarray(mel_lens), CHUNK_LEN)
    return np.asarray(ids), np.asarray(ofx)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def ref():
    """The JAX side, each function compiled once: the critic's forward and
    one D step on random chunks, and two adversarial FastPitch steps (meta,
    generator and critic parameters and vectors after each), with the
    generator's gradients of the first."""
    critic = jg.PatchDiscriminator(CNUM)
    d_vars = jax.jit(critic.init)({"params": jax.random.PRNGKey(1)},
                                  jnp.zeros((1, 128, 80, 1)))
    rng = np.random.default_rng(4)
    real = rng.standard_normal((3, 128, 80)).astype(np.float32) - 4.0
    fake = real + 0.3 * rng.standard_normal(real.shape).astype(np.float32)

    @jax.jit
    def fwd(v, x):
        return critic.apply(v, x[..., None], mutable=["spectral"])

    (score, fmaps), new_spec = fwd(d_vars, jnp.asarray(real))

    @jax.jit
    def d_grads(d_params, d_spectral):
        def loss(p):
            (d_org, _), _ = critic.apply(
                {"params": p, "spectral": d_spectral},
                jg.normalize_mel_chunk(jnp.asarray(real))[..., None],
                mutable=["spectral"])
            (d_gen, _), _ = critic.apply(
                {"params": p, "spectral": d_spectral},
                jg.normalize_mel_chunk(jnp.asarray(fake))[..., None],
                mutable=["spectral"])
            return (0.5 * jnp.mean((d_org - 1.0) ** 2)
                    + 0.5 * jnp.mean(d_gen ** 2))
        return jax.value_and_grad(loss)(d_params)

    loss_d, g_d = d_grads(d_vars["params"], d_vars["spectral"])

    # the adversarial FastPitch steps
    cfg = FastPitchConfig(**TINY, **NO_DROPOUT)
    model = FastPitch(cfg)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = jax.jit(lambda key: model.init(
        key, b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
        b["pitch_dense"], b["energy_dense"], b["attn_prior"],
        jnp.ones(b["tokens"].shape, jnp.float32), deterministic=True,
        method=FastPitch.forward_train))(jax.random.PRNGKey(0))
    tx, tx_d = make_optimizer(1e-4), make_optimizer(1e-4)
    state = TrainState(params=variables["params"],
                       opt_state=tx.init(variables["params"]),
                       step=jnp.asarray(0), d_params=d_vars["params"],
                       d_opt_state=tx_d.init(d_vars["params"]),
                       d_spectral=d_vars["spectral"])
    key = jax.random.PRNGKey(0)

    @jax.jit
    def g_grads(state, b):
        """The generator's gradients of the first step, the JAX step's
        arithmetic (`steps.py:120-176`) spelled out."""
        _, rng_chunk = jax.random.split(jax.random.fold_in(key, state.step))
        attn_soft, _ = model.apply({"params": state.params}, b["tokens"],
                                   b["mel_tgt"], b["attn_prior"],
                                   method=FastPitch.align_attention)
        hard, durs = jax_mas_durations(attn_soft, b["token_lens"],
                                       b["mel_lens"])

        def fwd_train(p):
            return model.apply(
                {"params": p}, b["tokens"], b["token_lens"], b["mel_tgt"],
                b["mel_lens"], b["pitch_dense"], b["energy_dense"],
                b["attn_prior"], durs, deterministic=True,
                method=FastPitch.forward_train)

        out_ng = fwd_train(state.params)
        (d_params, _, new_spec, fmaps_org, mel_ids, ofx,
         _) = _critic_losses(critic, state, b["mel_tgt"],
                             jax.lax.stop_gradient(out_ng["mel_out"]),
                             b["mel_lens"], rng_chunk, tx_d)

        def loss_fn(p):
            out = fwd_train(p)
            loss, _ = jax_losses.fastpitch_loss(out, b)
            loss = loss + jax_losses.attention_binarization_loss(
                hard, out["attn_soft"])
            fake = jg.normalize_mel_chunk(jg.extract_chunks(
                out["mel_out"], ofx, mel_ids, CHUNK_LEN))[..., None]
            (d_gen2, fmaps_gen), _ = critic.apply(
                {"params": d_params, "spectral": new_spec}, fake,
                mutable=["spectral"])
            return (loss + 3.0 * jnp.mean((d_gen2 - 1.0) ** 2)
                    + jg.feature_match_loss(fmaps_gen, fmaps_org))
        return jax.grad(loss_fn)(state.params)

    grads = g_grads(state, b)
    step = jax.jit(make_fastpitch_train_step(model, tx, critic, tx_d))
    chunks, metas, after = [], [], []
    for i in range(N_STEPS):
        chunks.append(_jax_chunks(key, i, _batch()["mel_lens"]))
        state, m = step(state, b, key)
        metas.append(jax.device_get(m))
        after.append(dict(
            model=_to_torch_tree(state.params, cfg),
            critic=_critic_to_torch(state.d_params, state.d_spectral)))
    return dict(d_vars=jax.device_get(d_vars), real=real, fake=fake,
                score=np.asarray(score), fmaps=[np.asarray(f) for f in fmaps],
                u=jax.device_get(new_spec["spectral"]), loss_d=float(loss_d),
                g_d=jax.device_get(g_d), cfg=cfg, variables=variables,
                grads=_to_torch_tree(grads, cfg), chunks=chunks, metas=metas,
                after=after)


def _port_critic(ref):
    critic = pg.PatchDiscriminator(CNUM)
    sd, spec = _critic_to_torch(ref["d_vars"]["params"],
                                ref["d_vars"]["spectral"])
    critic.load_state_dict(sd, strict=True)
    return critic, spec


def test_critic_scores_feature_maps_and_vectors_match_jax(ref):
    critic, spec = _port_critic(ref)
    before = {k: v.clone() for k, v in spec.items()}
    score, fmaps, new = critic(torch.from_numpy(ref["real"])[:, None], spec)
    assert len(fmaps) == 4 and score.shape == ref["score"].shape
    # the score is flattened NCHW here, NHWC in JAX: compare the maps
    last = score.detach().reshape(3, 4 * CNUM, 4, 3)
    np.testing.assert_allclose(
        last.permute(0, 2, 3, 1).reshape(3, -1).numpy(), ref["score"],
        rtol=0, atol=1e-5)
    for got, want in zip(fmaps, ref["fmaps"]):
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-5)
    for k, u in new.items():
        np.testing.assert_allclose(u.numpy(), ref["u"][k]["u"], rtol=0,
                                   atol=1e-6, err_msg=k)
        assert torch.equal(spec[k], before[k])     # the input is left as is


def test_critic_step_gradients_and_vectors_match_jax(ref):
    """One D step through the port's step code (`steps._Critic`) against
    JAX's loss and gradients; the vectors advance once and are those of a
    forward pass."""
    critic, spec = _port_critic(ref)
    state = port_steps.TrainState(None, None, critic=critic,
                                  d_optimizer=port_steps.make_optimizer(
                                      critic, 1e-4),
                                  spectral=spec)
    n = ref["real"].shape[0]
    c = port_steps._Critic(state, None, "cpu", 0,
                           (np.arange(n), np.zeros(n, np.int64)))
    grads = {}
    critic.conv1.weight.register_hook(
        lambda g: grads.setdefault("w", g.clone()))
    c.update(torch.from_numpy(ref["real"]), torch.from_numpy(ref["fake"]))
    np.testing.assert_allclose(float(c.loss_d), ref["loss_d"], rtol=1e-5)
    want = ref["g_d"]["conv1"]["kernel"].transpose(3, 2, 0, 1)
    err = np.abs(grads["w"].numpy() - want).max()
    assert err <= 1e-4 * np.linalg.norm(want), err
    for k, u in state.spectral.items():
        np.testing.assert_allclose(u.numpy(), ref["u"][k]["u"], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_sigma_is_a_constant_of_the_gradient():
    """JAX's spectral norm: sigma from the detached weight, so d(w/sigma)/dw
    is 1/sigma alone; torch's own spectral norm back-propagates through
    sigma and gives other gradients. The vector advances by one power
    iteration a forward and only where the caller keeps it."""
    g = torch.Generator().manual_seed(0)
    conv = pg.SNConv2d(3, 6)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
    u = torch.randn(6, 1, generator=g)
    x = torch.randn(2, 3, 16, 12, generator=g)
    r = torch.randn(2, 6, 8, 6, generator=g)

    y, u_new = conv(x, u)
    (y * r).sum().backward()
    got = conv.weight.grad.clone()

    w_mat = conv.weight.detach().reshape(6, -1)
    v = w_mat.T @ u / torch.linalg.vector_norm(w_mat.T @ u)
    u1 = w_mat @ v / torch.linalg.vector_norm(w_mat @ v)
    sigma = (u1.T @ w_mat @ v)[0, 0]
    torch.testing.assert_close(u_new, u1, rtol=0, atol=1e-6)

    w = conv.weight.detach().clone().requires_grad_()
    (torch.nn.functional.conv2d(x, w / sigma, conv.bias, stride=2,
                                padding=2) * r).sum().backward()
    torch.testing.assert_close(got, w.grad, rtol=1e-6, atol=1e-6)

    w2 = conv.weight.detach().clone().requires_grad_()
    m = w2.reshape(6, -1)
    s2 = (u1.T @ m @ v)[0, 0]       # sigma with its gradient
    (torch.nn.functional.conv2d(x, w2 / s2, conv.bias, stride=2,
                                padding=2) * r).sum().backward()
    assert (got - w2.grad).abs().max() > 1e-3 * got.abs().max()


@pytest.mark.parametrize("T_max,lens", [(200, [200, 150, 97]),
                                        (64, [64, 40, 9])],
                         ids=["long", "shorter_than_a_chunk"])
def test_extract_chunks_and_their_gradient_match_jax(T_max, lens):
    """JAX's chunk parameters and gather, mels shorter than a chunk
    included: negative offsets wrap once, then clamp; the gradient comes
    back only to the frames JAX's gather transposes to."""
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((3, T_max, 80)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    for seed in range(4):
        ids, ofx = jg.sample_chunk_params(jax.random.PRNGKey(seed), 3,
                                          jnp.asarray(lens), CHUNK_LEN)
        r = rng.standard_normal((3, CHUNK_LEN, 80)).astype(np.float32)
        want, want_g = jax.value_and_grad(
            lambda m: jnp.sum(jg.extract_chunks(m, ofx, ids, CHUNK_LEN) * r),
            )(jnp.asarray(mel))
        want = np.asarray(jg.extract_chunks(jnp.asarray(mel), ofx, ids,
                                            CHUNK_LEN))
        x = torch.from_numpy(mel).requires_grad_()
        got = pg.extract_chunks(x, torch.from_numpy(np.asarray(ofx)).long(),
                                torch.from_numpy(np.asarray(ids)).long(),
                                CHUNK_LEN)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        (got * torch.from_numpy(r)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-6)
        if T_max < CHUNK_LEN:
            assert (np.asarray(ofx) < 0).all()


def test_negative_and_past_the_end_indices_follow_jax():
    """On [0..9]: JAX's gather gives [0, 0, 7, 0, 9, 9] for
    [-14, -12, -3, 0, 9, 12], and its gradient reaches only the indices in
    range after the wrap (-3 -> 7, 0, 9)."""
    mel = torch.arange(10.0)[None, :, None].requires_grad_()
    ofx = torch.tensor([-14, -12, -3, 0, 9, 12])
    got = pg.extract_chunks(mel, ofx, torch.zeros(6, dtype=torch.long), 1)
    assert got[:, 0, 0].tolist() == [0, 0, 7, 0, 9, 9]
    (got[:, 0, 0] * torch.arange(1.0, 7.0)).sum().backward()
    assert mel.grad[0, :, 0].tolist() == [4, 0, 0, 0, 0, 0, 0, 3, 0, 5]


def test_chunk_params_follow_the_reference_clamp():
    """The port draws (ids, fraction) from its own generator; the offsets
    are JAX's formula on those draws: clipped to [0, len - 128], negative
    where len < 128."""
    lens = torch.tensor([500, 300, 129, 128, 90, 40])
    ids, ofx = pg.sample_chunk_params(torch.Generator().manual_seed(3), 6,
                                      lens, CHUNK_LEN)
    g = torch.Generator().manual_seed(3)
    ids2 = torch.randint(0, 6, (6,), generator=g)
    perc = torch.rand(6, generator=g)
    assert torch.equal(ids, ids2)
    out = lens[ids].float()
    want = np.clip(perc.numpy() * (out.numpy() + 128) - 64, 0,
                   out.numpy() - 128).astype(np.int32)
    np.testing.assert_array_equal(ofx.numpy(), want)
    assert ((ofx < 0) == (lens[ids] < 128)).all()


def test_feature_match_loss_matches_jax():
    rng = np.random.default_rng(7)
    gen = [rng.standard_normal((2, 4, 5, 3)).astype(np.float32)
           for _ in range(4)]
    org = [g + rng.standard_normal(g.shape).astype(np.float32) for g in gen]
    want = float(jg.feature_match_loss([jnp.asarray(a) for a in gen],
                                       [jnp.asarray(a) for a in org]))
    got_g = [torch.from_numpy(a).requires_grad_() for a in gen]
    got_o = [torch.from_numpy(a).requires_grad_() for a in org]
    loss = pg.feature_match_loss(got_g, got_o)
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    loss.backward()
    assert all(o.grad is None for o in got_o)      # the real side detached


def _port_state(ref):
    model = PortFastPitch(PortCfg(**TINY, **NO_DROPOUT))
    model.load_state_dict(convert.to_tensors(convert.fastpitch_params_to_torch(
        ref["variables"], ref["cfg"])), strict=True)
    critic, spec = _port_critic(ref)
    return port_steps.TrainState(
        model, port_steps.make_optimizer(model, 1e-4), critic=critic,
        d_optimizer=port_steps.make_optimizer(critic, 1e-4), spectral=spec)


def test_adversarial_fastpitch_steps_match_jax(ref):
    state = _port_state(ref)
    step = port_steps.make_fastpitch_train_step(device="cpu")
    params = dict(state.model.named_parameters())
    for i in range(N_STEPS):
        meta = step(state, _batch(), 0, chunks=ref["chunks"][i])
        want = ref["metas"][i]
        assert set(meta) == set(want)
        for k, v in meta.items():
            np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                       atol=0, err_msg=f"step {i}: {k}")
        if i == 0:
            assert float(meta["grad_norm"]) < port_steps.GRAD_CLIP
            for name, p in params.items():
                if p.grad is None:      # the unused Conv2d attn_proj
                    assert name.startswith("attention.attn_proj")
                    continue
                g_ref = ref["grads"][name].numpy()
                err = np.abs(p.grad.numpy() - g_ref).max()
                assert err <= 1e-4 * max(np.linalg.norm(g_ref), 1e-12), \
                    (name, err)
        # as in test_torch_port_train: the decoder attention's key bias has
        # a rounding-noise gradient, which Adam turns into steps in
        # [-lr, lr]
        sd = state.model.state_dict()
        for name, want_p in ref["after"][i]["model"].items():
            got, want_p = sd[name].numpy(), want_p.numpy()
            noise = np.zeros(got.shape, bool)
            if name.endswith("dec_attn.qkv_net.bias"):
                noise[8:16] = True
                assert np.abs(got - want_p)[noise].max() <= (i + 1) * 2e-4
            np.testing.assert_allclose(got[~noise], want_p[~noise], rtol=0,
                                       atol=1e-5,
                                       err_msg=f"after step {i + 1}: {name}")
        d_sd, d_spec = ref["after"][i]["critic"]
        for name, want_p in d_sd.items():
            np.testing.assert_allclose(
                state.critic.state_dict()[name].numpy(), want_p.numpy(),
                rtol=0, atol=1e-5, err_msg=f"critic after {i + 1}: {name}")
        for k, u in d_spec.items():
            np.testing.assert_allclose(state.spectral[k].numpy(), u.numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert state.step == N_STEPS


def test_the_step_draws_its_own_chunks_reproducibly(ref):
    """Without injected chunks the step draws them from (seed, step): two
    runs from the same state agree exactly, and the critic's parameters
    take gradients again after the generator's pass."""
    metas = []
    for _ in range(2):
        state = _port_state(ref)
        metas.append(port_steps.make_fastpitch_train_step(device="cpu")(
            state, _batch(), 5))
        assert all(p.requires_grad for p in state.critic.parameters())
    for k in metas[0]:
        assert torch.equal(metas[0][k], metas[1][k]), k
