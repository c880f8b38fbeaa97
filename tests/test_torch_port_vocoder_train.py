"""HiFi-GAN vocoder training: the port's device log-mel, MPD and MSD, GAN
losses, `ResBlock1Function`, D->G step, eval step, segment dataset,
staircase lr and CLI against the JAX package's (`train/vocoder.py`,
`vocoder/discriminators.py`, `apps/train_vocoder.py`), in f32 on the CPU,
at `tests/test_vocoder_train.py`'s sizes: `_tiny_modules()` (generator on
32 initial channels, periods (2, 3), two scales, width 0.25), segments of
2048 samples, batch 2. Inputs and weights are made with numpy from a seed;
weights cross over with `models.convert` (`hifigan_params_to_torch`,
`mpd_params_to_torch`, `msd_params_to_torch`).

Tolerances: the log-mel and its gradient 1e-5 of their peak; MPD and MSD
scores and feature maps 1e-5 (absolute); the three losses 1e-5 relative;
`ResBlock1Function`'s gradients 1e-5 of their norm, against autograd of
`resblock1_plain` and against `jax.grad` of the flax `ResBlock1`; one
whole D->G step: every meta term 1e-5 relative, the generator's and the
discriminators' gradients 1e-4 of their global norm, the updated
parameters 1e-6 absolute, except where the reference gradient is below
1e-6 of its tensor's largest: Adam's first step there is rounding noise
times lr / (|g| + eps), anywhere in [-lr, lr], so those elements are held
to 2 x lr; the eval step 1e-5 relative. Crops, batches and the lr are
exact."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_vocoder_train import SEG, _tiny_modules, corpus  # noqa: F401
from tts_arabic_torch.apps import train_vocoder as port_cli
from tts_arabic_torch.audio import mel as port_mel
from tts_arabic_torch.data import dataset as port_data
from tts_arabic_torch.models import convert
from tts_arabic_torch.ops import resblock as port_rb
from tts_arabic_torch.train import vocoder as port_voc
from tts_arabic_torch.train.steps import TrainState, make_optimizer
from tts_arabic_torch.vocoder import discriminators as pd
from tts_arabic_torch.vocoder.hifigan import (Generator as PortGenerator,
                                              HiFiGANConfig as PortConfig)
from tts_arabic_tpu.audio import mel as jax_mel
from tts_arabic_tpu.data import dataset as jax_data
from tts_arabic_tpu.train import vocoder as jax_voc
from tts_arabic_tpu.vocoder import discriminators as jd
from tts_arabic_tpu.vocoder.hifigan import ResBlock1 as FlaxResBlock1

LR = 2e-4
PORT_GEN = PortConfig(upsample_initial_channel=32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _waves(B=2, seed=0, n=SEG):
    """Two tones plus noise, [B, n] in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    f0 = 110.0 * (1 + np.arange(B))[:, None]
    return (0.4 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * rng.standard_normal((B, n))).astype(np.float32)


def _adamw():
    """The JAX CLI's optimizer at a constant lr."""
    return optax.chain(optax.clip_by_global_norm(1000.0),
                       optax.adamw(LR, b1=0.8, b2=0.99, weight_decay=0.01))


def _gen_sd(tree) -> dict:
    """A flax generator tree (parameters or gradients) -> the port's state
    dict: `hifigan_params_to_torch`'s weight-norm pairs hold v = w, so the
    weight is v itself, exactly."""
    sd = convert.hifigan_params_to_torch(jax.device_get(tree), PORT_GEN)
    return {k.replace("weight_v", "weight"): torch.tensor(np.asarray(v))
            for k, v in sd.items() if not k.endswith("weight_g")}


def _critic_sd(d_tree) -> dict:
    d_tree = jax.device_get(d_tree)
    sd = {f"mpd.{k}": v for k, v in
          convert.mpd_params_to_torch(d_tree["mpd"]).items()}
    sd.update({f"msd.{k}": v for k, v in
               convert.msd_params_to_torch(d_tree["msd"]).items()})
    return convert.to_tensors(sd)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, each function compiled once: the initial state, the
    discriminators' outputs, one D->G step of `make_hifigan_train_step`
    (meta, parameters after it) with its gradients (the step's arithmetic
    spelled out), and the eval step."""
    gen, mpd, msd = _tiny_modules()
    tx_g, tx_d = _adamw(), _adamw()
    # JAX's state shapes, filled from numpy (flax's eager init of these
    # modules takes half a minute on the CPU): kernels N(0, 1/fan_in),
    # biases N(0, 0.1^2)
    shapes = jax.eval_shape(lambda: jax_voc.init_vocoder_state(
        gen, mpd, msd, tx_g, tx_d, SEG))
    rng = np.random.default_rng(0)

    def fill(s):
        if len(s.shape) == 1:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape)
                / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
    params = jax.tree.map(fill, shapes.params)
    d_params = jax.tree.map(fill, shapes.d_params)
    state = shapes.replace(params=params, opt_state=tx_g.init(params),
                           step=jnp.asarray(0), d_params=d_params,
                           d_opt_state=tx_d.init(d_params))
    wave = jnp.asarray(_waves())
    fake = jnp.asarray(_waves(seed=1) * 0.7)
    cfg = jax_mel.MelConfig()

    @jax.jit
    def discs(d_params):
        return (mpd.apply({"params": d_params["mpd"]}, wave, fake),
                msd.apply({"params": d_params["msd"]}, wave, fake))

    @jax.jit
    def grads(state):
        mel_in = jax_voc._logmel(wave, cfg)
        y_ng = gen.apply({"params": state.params}, mel_in)

        def d_loss(dp):
            s_r, s_g, _, _ = mpd.apply({"params": dp["mpd"]}, wave, y_ng)
            loss_f, _, _ = jd.discriminator_loss(s_r, s_g)
            s_r, s_g, _, _ = msd.apply({"params": dp["msd"]}, wave, y_ng)
            loss_s, _, _ = jd.discriminator_loss(s_r, s_g)
            return loss_f + loss_s
        d_grads = jax.grad(d_loss)(state.d_params)
        d_up, _ = tx_d.update(d_grads, state.d_opt_state, state.d_params)
        d_params = optax.apply_updates(state.d_params, d_up)

        def g_loss(p):
            y = gen.apply({"params": p}, mel_in)
            loss = 45.0 * jnp.mean(jnp.abs(jax_voc._logmel(y, cfg) - mel_in))
            for disc, name in ((mpd, "mpd"), (msd, "msd")):
                _, s_g, f_r, f_g = disc.apply({"params": d_params[name]},
                                              wave, y)
                loss += jd.generator_loss(s_g)[0] + jd.feature_loss(f_r, f_g)
            return loss
        return d_grads, jax.grad(g_loss)(state.params)

    d_out = jax.device_get(discs(state.d_params))
    d_grads, g_grads = jax.device_get(grads(state))
    eval_meta, figures = jax.jit(jax_voc.make_hifigan_eval_step(gen))(
        state, {"wave": wave}, None)
    step = jax.jit(jax_voc.make_hifigan_train_step(gen, mpd, msd, tx_g,
                                                   tx_d))
    after, meta = step(state, {"wave": wave}, jax.random.PRNGKey(0))
    return dict(state=jax.device_get(state), wave=np.array(wave),
                fake=np.array(fake), d_out=d_out,
                d_grads=_critic_sd(d_grads), g_grads=_gen_sd(g_grads),
                eval=jax.device_get(eval_meta), figures=figures,
                meta=jax.device_get(meta), gen_after=_gen_sd(after.params),
                critic_after=_critic_sd(after.d_params))


def _port_state(ref) -> TrainState:
    gen, mpd, msd = (PortGenerator(PORT_GEN),
                     pd.MultiPeriodDiscriminator((2, 3), width=0.25),
                     pd.MultiScaleDiscriminator(2, width=0.25))
    state = port_voc.init_vocoder_state(gen, mpd, msd, g_lr=LR, d_lr=LR,
                                        device="cpu")
    state.model.load_state_dict(_gen_sd(ref["state"].params), strict=True)
    state.critic.load_state_dict(_critic_sd(ref["state"].d_params),
                                 strict=True)
    return state


# ---- the device log-mel ------------------------------------------------------

def test_log_mel_and_its_gradient_match_jax():
    wave = _waves(seed=3, n=SEG)
    r = np.random.default_rng(4).standard_normal(
        (2, 80, SEG // 256)).astype(np.float32)
    cfg = jax_mel.MelConfig()
    want, want_g = jax.value_and_grad(
        lambda x: jnp.sum(jax_mel.log_mel_spectrogram(x, cfg) * r))(
        jnp.asarray(wave))
    want_mel = np.asarray(jax_mel.log_mel_spectrogram(jnp.asarray(wave),
                                                      cfg))
    x = torch.from_numpy(wave).requires_grad_()
    got = port_mel.log_mel_spectrogram(x)
    assert got.shape == (2, 80, SEG // 256)          # S/hop frames exactly
    err = np.abs(got.detach().numpy() - want_mel).max()
    assert err <= 1e-5 * np.abs(want_mel).max(), err
    (got * torch.from_numpy(r)).sum().backward()
    want_g = np.asarray(want_g)
    err = np.abs(x.grad.numpy() - want_g).max()
    assert err <= 1e-5 * np.abs(want_g).max(), err
    # the magnitude and mel spectrogram of the wrapper, and a 1-D waveform
    np.testing.assert_allclose(
        port_mel.MelSpectrogram()(wave).numpy(),
        np.asarray(jax_mel.mel_spectrogram(jnp.asarray(wave), cfg)),
        rtol=1e-5, atol=1e-6)
    assert port_mel.stft_magnitude(torch.from_numpy(wave[0])).shape == (
        513, SEG // 256)


def test_log_mel_gradient_is_finite_where_the_spectrum_vanishes():
    """Silence: |X| = 0 in every bin; re^2 + im^2 + 1e-9 keeps the
    square root's gradient finite, as JAX's |X|^2 does."""
    x = torch.zeros((1, 1024), requires_grad=True)
    port_mel.log_mel_spectrogram(x).sum().backward()
    assert torch.isfinite(x.grad).all()


# ---- MPD, MSD and the losses -------------------------------------------------

def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nwc(t):
    return t.detach().permute(0, 2, 1).numpy()


@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_discriminator_scores_and_feature_maps_match_jax(ref, which):
    disc = (pd.MultiPeriodDiscriminator((2, 3), width=0.25) if which == "mpd"
            else pd.MultiScaleDiscriminator(2, width=0.25))
    sd = _critic_sd(ref["state"].d_params)
    disc.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()
                          if k.startswith(which)}, strict=True)
    want = ref["d_out"][0 if which == "mpd" else 1]
    with torch.no_grad():
        got = disc(torch.from_numpy(ref["wave"]), torch.from_numpy(
            ref["fake"]))
    layout = _nhwc if which == "mpd" else _nwc
    n_maps = 0
    for i in range(2):                  # scores of the real, then the fake
        for g, w in zip(got[i], want[i]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)
    for i in (2, 3):                    # feature maps, layer by layer
        for fg, fw in zip(got[i], want[i]):
            assert len(fg) == len(fw)
            for g, w in zip(fg, fw):
                np.testing.assert_allclose(layout(g), np.asarray(w), rtol=0,
                                           atol=1e-5)
                n_maps += 1
    assert n_maps == 2 * 2 * (6 if which == "mpd" else 8)


def test_period_fold_pads_by_reflection():
    """T % p != 0: the waveform is reflect-padded to a multiple of p before
    the [B, 1, T/p, p] fold."""
    d = pd.PeriodDiscriminator(3, width=0.125)
    x = torch.arange(10.0)[None]
    seen = []
    d.conv_0.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    d(x)
    assert seen[0].shape == (1, 1, 4, 3)
    assert seen[0].flatten().tolist() == list(range(10)) + [8.0, 7.0]


def test_gan_losses_match_jax():
    rng = np.random.default_rng(5)
    real = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 5)]
    gen = [rng.standard_normal((2, n)).astype(np.float32) for n in (7, 5)]
    f_r = [[rng.standard_normal((2, 3, 4)).astype(np.float32)
            for _ in range(2)] for _ in range(2)]
    f_g = [[a + rng.standard_normal(a.shape).astype(np.float32)
            for a in fr] for fr in f_r]
    J = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    T = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    want = (float(jd.discriminator_loss(J(real), J(gen))[0]),
            float(jd.generator_loss(J(gen))[0]),
            float(jd.feature_loss(J(f_r), J(f_g))))
    tf_r = [[t.requires_grad_() for t in fr] for fr in T(f_r)]
    got = (float(pd.discriminator_loss(T(real), T(gen))[0]),
           float(pd.generator_loss(T(gen))[0]),
           pd.feature_loss(tf_r, T(f_g)))
    np.testing.assert_allclose([*got[:2], float(got[2])], want, rtol=1e-5)
    assert got[2].grad_fn is None           # the real maps are detached


# ---- ResBlock1Function -------------------------------------------------------

@pytest.mark.parametrize("k", [3, 7, 11])
def test_resblock1_function_gradients_match_autograd_and_jax(k):
    """Gradients of sum(y * r) for x and the four stacked weights: the
    Function (plain forward under no_grad, recompute in the backward)
    against autograd through `resblock1_plain` and against `jax.grad` of
    the flax ResBlock1."""
    C, T, dil = 16, 200, (1, 3, 5)
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    r = rng.standard_normal((2, T, C)).astype(np.float32)
    params = {f"{n}_{i}": {
        "kernel": (rng.standard_normal((k, C, C)) / np.sqrt(k * C)
                   ).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)}
        for i in range(3) for n in ("conv1", "conv2")}
    block = FlaxResBlock1(C, k, dil)
    g_x, g_p = jax.grad(lambda x, p: jnp.sum(block.apply(
        {"params": p}, x) * r), argnums=(0, 1))(jnp.asarray(x), params)

    def stacked(tree, name, part):
        a = [np.asarray(tree[f"{name}_{i}"][part]) for i in range(3)]
        return np.stack([w.transpose(2, 1, 0) for w in a] if part == "kernel"
                        else a)
    want = [np.asarray(g_x)] + [stacked(g_p, n, part) for n, part in (
        ("conv1", "kernel"), ("conv1", "bias"), ("conv2", "kernel"),
        ("conv2", "bias"))]
    inputs = [x] + [stacked(params, n, part) for n, part in (
        ("conv1", "kernel"), ("conv1", "bias"), ("conv2", "kernel"),
        ("conv2", "bias"))]

    def grads(fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
        y = fn(*leaves, k, dil)
        (y * torch.from_numpy(r)).sum().backward()
        return y.detach(), [t.grad.numpy() for t in leaves]

    y_fn, got = grads(port_rb.ResBlock1Function.apply)
    y_plain, plain = grads(port_rb.resblock1_plain)
    assert torch.equal(y_fn, y_plain)
    for name, g, p, w in zip(("x", "w1", "b1", "w2", "b2"), got, plain,
                             want):
        assert np.abs(g - p).max() <= 1e-5 * np.linalg.norm(p), name
        assert np.abs(g - w).max() <= 1e-5 * np.linalg.norm(w), name
    # resblock1 routes through the Function while a gradient is recorded
    leaves = [torch.tensor(a, requires_grad=True) for a in inputs]
    y = port_rb.resblock1(*leaves, k, dil)
    assert type(y.grad_fn).__name__ == "ResBlock1FunctionBackward"
    with torch.no_grad():
        assert port_rb.resblock1(*leaves, k, dil).grad_fn is None


def test_resblock1_function_skips_inputs_that_need_no_gradient():
    C, k = 8, 3
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 30, C), generator=g, requires_grad=True)
    w1, w2 = (torch.randn((1, C, C, k), generator=g) * 0.1
              for _ in range(2))
    b1, b2 = (torch.zeros((1, C)) for _ in range(2))
    port_rb.resblock1(x, w1, b1, w2, b2, k, (1,)).sum().backward()
    assert x.grad is not None and w1.grad is None and b2.grad is None


# ---- the D->G step, the eval step --------------------------------------------

def test_hifigan_step_matches_jax(ref):
    state = _port_state(ref)
    step = port_voc.make_hifigan_train_step(device="cpu")
    meta = step(state, {"wave": ref["wave"]}, 0)
    want = ref["meta"]
    assert set(meta) == set(want)
    for k, v in meta.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                   atol=0, err_msg=k)
    assert state.step == 1
    for label, module, g_ref, p_ref in (
            ("generator", state.model, ref["g_grads"], ref["gen_after"]),
            ("critic", state.critic, ref["d_grads"], ref["critic_after"])):
        params = dict(module.named_parameters())
        assert params.keys() == g_ref.keys()
        diff = np.sqrt(sum(float(((params[n].grad - g) ** 2).sum())
                           for n, g in g_ref.items()))
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in g_ref.values()))
        assert diff <= 1e-4 * norm, (label, diff, norm)
        for n, p in params.items():
            g = g_ref[n].numpy()
            noise = np.abs(g) < 1e-6 * np.abs(g).max()
            err = np.abs(p.detach().numpy() - p_ref[n].numpy())
            assert err[~noise].max(initial=0.0) <= 1e-6, (label, n)
            assert err[noise].max(initial=0.0) <= 2 * LR, (label, n)


def test_hifigan_eval_step_matches_jax(ref):
    state = _port_state(ref)
    meta, figures = port_voc.make_hifigan_eval_step(device="cpu")(
        state, {"wave": ref["wave"]})
    assert figures is None and ref["figures"] is None
    assert set(meta) == set(ref["eval"])
    for k, v in meta.items():
        np.testing.assert_allclose(float(v), float(ref["eval"][k]),
                                   rtol=1e-5, err_msg=k)


# ---- data, lr, CLI -----------------------------------------------------------

def test_segment_dataset_crops_and_batches_equal_jax(corpus):  # noqa: F811
    """Two epochs of batches (the permutation at construction, then the
    trainer's reshuffle), each read twice (fresh crops each visit): the
    same files, crops and zero-padded short clip as JAX's for one seed."""
    root, wav_dir = corpus
    kw = dict(segment_length=SEG, batch_size=3, seed=7)
    port = port_data.VocoderSegmentDataset(root / "train.txt", wav_dir, **kw)
    jax_ds = jax_data.VocoderSegmentDataset(root / "train.txt", wav_dir,
                                            **kw)
    assert len(port) == len(jax_ds) == 2
    padded = 0
    for _ in range(2):
        port.shuffle()
        jax_ds.shuffle()
        for b in range(len(port)):
            for _ in range(2):
                got = port_data.collate_vocoder(port[b])["wave"]
                want = jax_data.collate_vocoder(jax_ds[b])["wave"]
                assert got.dtype == np.float32 and got.shape[1] == SEG
                np.testing.assert_array_equal(got, want)
                padded += int((got[:, 1024:] == 0).all(axis=1).sum())
    assert padded == 4                  # the 1024-sample clip, each visit
    for ds_cls in (port_data.VocoderSegmentDataset,
                   jax_data.VocoderSegmentDataset):
        with pytest.raises(ValueError, match="hop"):
            ds_cls(root / "train.txt", wav_dir, segment_length=1000)


def test_staircase_lr_matches_optax_over_two_epochs_and_a_restore():
    """lr at update n = base x decay^(n // steps_per_epoch), n counted
    before the update, as optax's schedule reads its count; an optimizer
    restored from a state dict goes on from the restored count."""
    base, decay, per_epoch = 2e-4, 0.5, 3
    sched = optax.exponential_decay(base, transition_steps=per_epoch,
                                    decay_rate=decay, staircase=True)
    p = torch.nn.Parameter(torch.zeros(2))
    opt = make_optimizer(torch.nn.ParameterList([p]), base, 0.8, 0.99)
    for n in range(2 * per_epoch):
        port_voc.staircase_lr(opt, n, decay, per_epoch)
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(sched(n)), rtol=1e-6)
    fresh = make_optimizer(torch.nn.ParameterList([p]), base, 0.8, 0.99)
    fresh.load_state_dict(opt.state_dict())
    for n in range(2 * per_epoch, 3 * per_epoch + 1):
        port_voc.staircase_lr(fresh, n, decay, per_epoch)
        np.testing.assert_allclose(fresh.param_groups[0]["lr"],
                                   float(sched(n)), rtol=1e-6)


def _cli_config(root, wav_dir, tmp_path, **over) -> pathlib.Path:
    gen_cfg = {"resblock": "1", "upsample_rates": [8, 8, 2, 2],
               "upsample_kernel_sizes": [16, 16, 4, 4],
               "upsample_initial_channel": 32,
               "resblock_kernel_sizes": [3, 7],
               "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
               "num_mels": 80, "sampling_rate": 22050}
    (tmp_path / "gen.json").write_text(json.dumps(gen_cfg))
    cfg = {"restore_model": "", "log_dir": str(tmp_path / "logs"),
           "checkpoint_dir": str(tmp_path / "ckpt"),
           "train_wavs_path": str(wav_dir),
           "train_labels": str(root / "train.txt"),
           "test_wavs_path": str(wav_dir),
           "test_labels": str(root / "test.txt"),
           "label_pattern": '"(?P<filename>.*)" "(?P<phonemes>.*)"',
           "vocoder_state_path": "",
           "vocoder_config_path": str(tmp_path / "gen.json"),
           "segment_length": SEG, "batch_size": 2, "mpd_periods": [2, 3],
           "msd_scales": 2, "disc_width": 0.25, "g_lr": LR, "g_beta1": 0.8,
           "g_beta2": 0.99, "d_lr": LR, "d_beta1": 0.8, "d_beta2": 0.99,
           "lr_decay": 0.5, "n_save_states_iter": 1,
           "n_save_backup_iter": 1000, "epochs": 2, **over}
    path = tmp_path / "config.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n"
                            for k, v in cfg.items()))
    return path


def test_train_vocoder_cli_two_epochs_restore_and_warm_start(
        corpus, tmp_path):  # noqa: F811
    from tts_arabic_torch.models.layers import init_weights
    from tts_arabic_torch.runtime.checkpoint import load_states
    from tts_arabic_torch.train.trainer import Trainer
    root, wav_dir = corpus
    path = _cli_config(root, wav_dir, tmp_path)
    trainer = port_cli.main(["--config", str(path), "--device", "cpu",
                             "--log-every", "1", "--no-mesh"])
    state = trainer.state
    assert state.step == 4                      # 4 clips, batch 2, 2 epochs
    rows = [json.loads(line) for line in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if "train/loss" in r]
    assert len(train_rows) == 4
    for r in train_rows:
        for k in ("loss", "loss_d", "d_mpd_loss", "d_msd_loss", "mel_loss",
                  "gen_adv_loss", "feat_loss"):
            assert np.isfinite(r[f"train/{k}"]), (k, r)
    val = [r["val/loss"] for r in rows if "val/loss" in r]
    assert len(val) == 2 and all(np.isfinite(val))
    # the last update (n = 3, epoch 1) ran at lr x 0.5
    assert state.optimizer.param_groups[0]["lr"] == LR * 0.5
    # both networks moved from their seeded init
    gen0 = init_weights(PortGenerator(PortConfig.from_json(
        tmp_path / "gen.json")), 42)
    moved = [not torch.equal(p.detach(), q) for p, q in
             zip(state.model.parameters(), gen0.parameters())]
    assert all(moved), moved
    mpd0 = init_weights(pd.MultiPeriodDiscriminator((2, 3), 0.25), 43)
    assert all(not torch.equal(p.detach(), q) for p, q in zip(
        state.critic["mpd"].parameters(), mpd0.parameters()))
    # the checkpoint holds JAX's keys and restores every tree equal
    st = load_states(tmp_path / "ckpt" / "states.ckpt")
    assert {"model", "optim", "model_d", "optim_d"} <= set(st)
    assert "spectral_d" not in st
    assert st["config"]["net_config"]["upsample_initial_channel"] == 32
    fresh = port_voc.init_vocoder_state(
        PortGenerator(state.model.config),
        pd.MultiPeriodDiscriminator((2, 3), 0.25),
        pd.MultiScaleDiscriminator(2, 0.25), seed=9, device="cpu")
    restorer = Trainer(None, fresh, log_dir=tmp_path / "restore",
                       checkpoint_dir=tmp_path / "ckpt", device="cpu")
    assert restorer.restore() == 4
    restorer.close()
    for a, b in ((state.model, fresh.model), (state.critic, fresh.critic)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for a, b in ((state.optimizer, fresh.optimizer),
                 (state.d_optimizer, fresh.d_optimizer)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa["param_groups"] == sb["param_groups"]
        for i, s in sa["state"].items():
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(s[k], sb["state"][i][k]), (i, k)

    # a warm start from a reference-layout `.pth` (weight norm as
    # weight_g / weight_v under "generator"), no update taken
    ref_gen = init_weights(PortGenerator(state.model.config), 5)
    sd = {}
    for k, v in ref_gen.state_dict().items():
        if k.endswith(".weight") and "ups" not in k and v.dim() == 3:
            g = torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=1)
            sd[k[:-6] + "weight_g"] = g.reshape(-1, 1, 1)
            sd[k[:-6] + "weight_v"] = v.clone()
        else:
            sd[k] = v
    torch.save({"generator": sd}, tmp_path / "ref.pth")
    warm = _cli_config(root, wav_dir, tmp_path, test_labels="",
                       vocoder_state_path=str(tmp_path / "ref.pth"),
                       checkpoint_dir=str(tmp_path / "ckpt_warm"),
                       log_dir=str(tmp_path / "logs_warm"))
    got = port_cli.main(["--config", str(warm), "--device", "cpu",
                         "--max-steps", "0"]).state.model.state_dict()
    for k, v in ref_gen.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=1e-6, atol=1e-7)
    cold = port_cli.main(["--config", str(warm), "--device", "cpu",
                          "--max-steps", "0", "--from-scratch"])
    assert torch.equal(cold.state.model.conv_pre.weight,
                       gen0.conv_pre.weight)
