"""The port's parallel layer (`tts_arabic_torch.parallel`) on the CPU: one
world of 4 gloo ranks for the module (spawned processes, a FileStore in a
temp dir, one intra-op thread each; `torch_port_parallel_worker.py` runs
every case and returns its numbers), held against the JAX package's
`parallel` on the 8 virtual devices of `tests/conftest.py`
(`make_mesh(n_devices=4)`, `make_mesh_2d(2, 2)`, `make_mesh_dp_tp(2, 2)`),
computed here while the ranks run. Weights are drawn in the port's layout
with numpy or the port's seeded init and cross over with the JAX package's
`.pth` importers.

Cases, mirroring the JAX tests: `test_runtime.py`'s DP psum step,
`pad_batch_to_devices`, DP inference (the port's DP call within 1e-6 of
its one-process call, and within the pipeline tests' 50 dB of JAX's DP
call) and the six `sp_vocode` cases (2e-6 against the one-device call);
`test_tp.py` (the split keys, too few ranks, one all-reduce per FFN and no
gather of the hidden activation, infer within rtol 2e-4 / atol 2e-5);
`test_parallel_multiprocess.py` (a 2-rank step against one process, rtol
2e-4). Then the traps of exactness, each held against JAX's
`data_parallel_jit` over 4 devices and each checked to catch the naive
DDP version: a FastPitch step whose ranks hold unequal lengths (loss terms
1e-5 relative, gradients 1e-4 of their norm), a Tacotron2 step's
BatchNorm statistics (1e-6) and a clipped step's gradients; and the
adversarial and vocoder steps and `Trainer(mesh=)` against the port's
own one-process runs. Dropout is off throughout.
"""
import dataclasses
import functools
import pathlib
import pickle
import queue as queue_mod
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_parallel_worker as worker
from torch_port_weights import (tacotron2_state_dict, vocos_state_dict,
                                write_weights)
from tts_arabic_torch.models import convert
from tts_arabic_torch.models.fastpitch import (FastPitch as PortFastPitch,
                                               FastPitchConfig as PortCfg)
from tts_arabic_torch.models import tacotron2 as port_t2
from tts_arabic_torch.models.layers import init_weights
from tts_arabic_torch.train import gan as port_gan
from tts_arabic_torch.vocoder.hifigan import Generator as PortGenerator
from tts_arabic_torch.vocoder.hifigan import HiFiGANConfig as PortHiFiCfg
from tts_arabic_torch.vocoder.vocos import MelVocosModule as PortVocos
from tts_arabic_tpu import parallel as jp
from tts_arabic_tpu.align.mas import mas_durations as jax_mas_durations
from tts_arabic_tpu.infer import FastPitch2Wave as JaxPipe
from tts_arabic_tpu.models import tacotron2 as jax_t2
from tts_arabic_tpu.models.fastpitch import FastPitch, FastPitchConfig
from tts_arabic_tpu.models.torch_import import (fastpitch_params_from_torch,
                                                hifigan_params_from_torch,
                                                tacotron2_params_from_torch)
from tts_arabic_tpu.train import losses as jax_losses
from tts_arabic_tpu.vocoder.hifigan import Generator, HiFiGANConfig

WORLD = 4
TINY = dict(d_model=32, enc_n_layers=1, dec_n_layers=1, enc_d_head=8,
            dec_d_head=8, enc_filter_size=64, dec_filter_size=64,
            dur_filter_size=16, pitch_filter_size=16, energy_filter_size=16,
            attn_channels=8)
NO_DROPOUT = {f.name: 0.0 for f in dataclasses.fields(FastPitchConfig)
              if "drop" in f.name}
TP_CFG = dict(TINY, enc_n_layers=2, dec_n_layers=2)   # test_tp.py's CFG
MP_CFG = dict(d_model=64, enc_n_layers=1, dec_n_layers=1, enc_d_head=16,
              dec_d_head=16, enc_filter_size=128, dec_filter_size=128,
              dur_filter_size=32, pitch_filter_size=32,
              energy_filter_size=32, attn_channels=16)  # mp_worker's
T2_CFG = dict(n_symbols=40, symbol_embedding_dim=16,
              encoder_embedding_dim=16, num_speakers=1, decoder_rnn_dim=24,
              attention_rnn_dim=24, attention_hidden_dim=8,
              attention_location_n_filters=4,
              attention_location_kernel_size=7, prenet_dim=8,
              postnet_embedding_dim=16, postnet_n_convolutions=2, n_mels=80,
              prenet_dropout=0.0, attention_dropout=0.0,
              decoder_dropout=0.0)   # test_train_steps.T2_CFG, no dropout
GEN_CFG = dict(upsample_initial_channel=32)
VOCOS_CFG = dict(n_mels=80, dim=48, intermediate_dim=96, num_layers=8)
TEXTS = ["bisomi {ll~ahi", ">aholFA wasaholFA", "kayofa HAluka",
         "SabAHu {loxayori", "$ukorFA", "mar~aHabFA bikum",
         "layolapN saEiydapN", "SabAHu {ln~uwri"]
CLIP = 1e-3             # far under the gradient norm: the clip acts
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BUDGET_S = 600.0        # the ranks' results, at most


def _fp_batch(seed=0, B=4, T_txt=16, T_mel=128,
              token_lens=(16, 11, 7, 13), mel_lens=(128, 100, 70, 96)):
    """Collated-shape FastPitch batch, each row its own lengths (so each
    rank of 4 holds its own): zero-padded tokens and mels, unvoiced pitch
    frames, the beta-binomial prior."""
    from tts_arabic_torch.align.prior import BetaBinomialInterpolator
    rng = np.random.default_rng(seed)
    token_lens = np.asarray(token_lens[:B], np.int32)
    mel_lens = np.asarray(mel_lens[:B], np.int32)
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


def _t2_batch(seed=1, B=4, T_txt=10, T_mel=40):
    rng = np.random.default_rng(seed)
    token_lens = np.array([10, 7, 9, 5][:B], np.int32)
    mel_lens = np.array([40, 31, 36, 22][:B], np.int32)
    tokens = rng.integers(1, 40, (B, T_txt)).astype(np.int32)
    mel = rng.standard_normal((B, T_mel, 80)).astype(np.float32) - 4.0
    gate = np.zeros((B, T_mel), np.float32)
    for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
        tokens[i, nt:] = 0
        mel[i, nm:] = 0.0
        gate[i, nm - 1:] = 1.0
    return {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
            "gate_tgt": gate, "mel_lens": mel_lens}


def _sd(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            model.state_dict().items()}


def _inputs(tmp: pathlib.Path) -> dict:
    """Every case's inputs, made with numpy and the port's seeded init."""
    rng = np.random.default_rng(7)
    fp = init_weights(PortFastPitch(PortCfg(**TINY, **NO_DROPOUT)), 0)
    tp = init_weights(PortFastPitch(PortCfg(**TP_CFG)), 0)
    with torch.no_grad():
        tp.duration_predictor.fc.bias.add_(2.0)
    mp = init_weights(PortFastPitch(PortCfg(**MP_CFG, **NO_DROPOUT)), 0)
    gen = init_weights(PortGenerator(PortHiFiCfg(**GEN_CFG)), 7)
    vocos_sd = vocos_state_dict(PortVocos(**VOCOS_CFG), 11)
    t2_sd = tacotron2_state_dict(port_t2.Tacotron2Config(**T2_CFG), seed=0)
    ids, ofx = port_gan.sample_chunk_params(
        torch.Generator().manual_seed(3), 4,
        torch.tensor([128, 100, 70, 96]), port_gan.CHUNK_LEN)
    ids[1] = ids[0]     # two chunks of one row: a rank scores none

    def mel(B, F, C=80):
        return rng.standard_normal((B, F, C)).astype(np.float32) - 5.0

    mp_batch = _fp_batch(2, B=8, token_lens=(16, 11, 7, 13) * 2,
                         mel_lens=(128, 100, 70, 96) * 2)
    return dict(
        psum_w=np.asarray([[2.0, 0.0], [0.0, 1.0]], np.float32),
        psum_batch={"x": np.arange(16.0, dtype=np.float32).reshape(8, 2),
                    "y": np.ones((8, 2), np.float32)},
        pipe_weights=write_weights(tmp / "weights", seed=3,
                                   duration_bias=2.0),
        texts=TEXTS,
        gen_sd=_sd(gen), gen_cfg=GEN_CFG,
        vocos_sd={k: v.numpy() for k, v in vocos_sd.items()},
        vocos_cfg=VOCOS_CFG,
        mel_div=mel(2, 4 * 32), mel_ragged=mel(2, 4 * 32 + 17),
        mel_short=mel(2, 40), mel_vocos=mel(1, 4 * 64),
        mel_2d=mel(4, 2 * 32 + 9), mel_two=mel(1, 2 * 40),
        tp_cfg=TP_CFG, tp_sd=_sd(tp),
        tp_tokens=rng.integers(1, 40, (4, 12)).astype(np.int64),
        fp_cfg=dict(TINY, **NO_DROPOUT), fp_sd=_sd(fp),
        fp_batch=_fp_batch(0), fp_batch2=_fp_batch(1), clip=CLIP,
        adv_chunks=(ids.numpy(), ofx.numpy()),
        mp_cfg=dict(MP_CFG, **NO_DROPOUT), mp_sd=_sd(mp), mp_batch=mp_batch,
        t2_cfg=T2_CFG, t2_sd={k: v.numpy() for k, v in t2_sd.items()},
        t2_batch=_t2_batch(),
        waves=(0.3 * rng.standard_normal((4, 2048))).astype(np.float32),
        trainer_dir=str(tmp / "trainer"))


# --- JAX's side, on the 8 virtual devices -----------------------------------

def _mesh4():
    return jp.make_mesh(n_devices=4)


def _jax_fastpitch_grads(inp):
    """JAX's DP value_and_grad of the FastPitch loss (+ the binarization
    KL), as its train step computes them, over the global batch."""
    cfg = FastPitchConfig(**inp["fp_cfg"])
    model = FastPitch(cfg)
    params = jax.tree.map(jnp.asarray, fastpitch_params_from_torch(
        inp["fp_sd"], cfg)["params"])

    def fn(params, b):
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
            meta["loss"] = loss + kl
            return loss + kl, meta

        (_, meta), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return meta, grads

    mesh = _mesh4()
    b = jp.shard_batch({k: jnp.asarray(v) for k, v in
                        inp["fp_batch"].items()}, mesh)
    meta, grads = jp.data_parallel_jit(fn, mesh)(jp.replicate(params, mesh),
                                                 b)
    grads = {k: np.asarray(v) for k, v in convert.fastpitch_params_to_torch(
        jax.device_get(grads), cfg).items()}
    return {k: float(v) for k, v in jax.device_get(meta).items()}, grads


def _jax_tacotron(inp):
    """JAX's DP Tacotron2 loss, gradients and BatchNorm statistics (the
    conv-block dropout patched out, as the port's parity tests do)."""
    cfg = jax_t2.Tacotron2Config(**T2_CFG)
    model = jax_t2.Tacotron2(cfg)
    variables = jax.tree.map(jnp.asarray, tacotron2_params_from_torch(
        inp["t2_sd"], cfg))

    def fn(variables, b):
        def loss_fn(p):
            (m_out, m_post, gates, _), mut = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
                train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            loss, meta = jax_losses.tacotron2_loss(
                m_out, m_post, gates, b["mel_tgt"], b["gate_tgt"],
                b["mel_lens"])
            return loss, (meta, mut)

        (_, (meta, mut)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return meta, grads, mut

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_t2.Tacotron2, "_dropout",
                   lambda self, x, rate, train: x)
        mesh = _mesh4()
        b = jp.shard_batch({k: jnp.asarray(v) for k, v in
                            inp["t2_batch"].items()}, mesh)
        meta, grads, mut = jax.device_get(jp.data_parallel_jit(fn, mesh)(
            jp.replicate(variables, mesh), b))
    tree = convert.tacotron2_params_to_torch(
        {"params": grads, "batch_stats": mut["batch_stats"]}, cfg)
    stats = {k: np.asarray(v) for k, v in tree.items() if "running" in k}
    grads = {k: np.asarray(v) for k, v in tree.items()
             if "running" not in k and "num_batches" not in k}
    return {k: float(v) for k, v in meta.items()}, grads, stats


def _jax_sp(inp):
    """JAX's split call of the 2-D case (ragged time axis, DP x SP),
    compiled (an eager shard_map takes a minute on the CPU)."""
    gcfg = HiFiGANConfig(**GEN_CFG)
    gen = Generator(gcfg)
    gv = jax.tree.map(jnp.asarray, hifigan_params_from_torch(inp["gen_sd"],
                                                             gcfg))
    fn = jax.jit(functools.partial(
        jp.sp_vocode, gen.apply, mesh=jp.make_mesh_2d(2, 2),
        axis=jp.SEQ_AXIS, batch_axis=jp.DATA_AXIS))
    return {"2d": np.asarray(fn(gv, jnp.asarray(inp["mel_2d"])))}


def _jax_psum(inp):
    mesh = _mesh4()

    def step(params, batch):
        def loss_fn(params):
            pred = batch["x"] @ params["w"]
            return jnp.mean((pred - batch["y"]) ** 2)
        return jax.value_and_grad(loss_fn)(params)

    loss, grad = jp.data_parallel_jit(step, mesh)(
        {"w": jnp.asarray(inp["psum_w"])},
        jp.shard_batch({k: jnp.asarray(v)
                        for k, v in inp["psum_batch"].items()}, mesh))
    return float(loss), np.asarray(grad["w"])


def _jax_tp(inp):
    cfg = FastPitchConfig(**TP_CFG)
    variables = jax.tree.map(jnp.asarray,
                             fastpitch_params_from_torch(inp["tp_sd"], cfg))
    fn, sharded = jp.tp_mel_infer_jit(FastPitch(cfg), variables,
                                      jp.make_mesh_dp_tp(2, 2),
                                      max_frames=64)
    return jax.device_get(fn(sharded, jnp.asarray(inp["tp_tokens"],
                                                  jnp.int32)))


def _jax_serving(inp):
    fp, voc, voc_json = inp["pipe_weights"]
    pipe = JaxPipe(fp, vocoder_sd=voc, vocoder_config=voc_json,
                   arabic_in=False, mesh=_mesh4())
    return pipe.tts(inp["texts"], batch_size=8, denoise=0.003)


JAX_JOBS = {"psum": _jax_psum, "fastpitch": _jax_fastpitch_grads,
            "sp": _jax_sp, "tacotron": _jax_tacotron, "tp": _jax_tp,
            "serving": _jax_serving}
HELPER_JOBS = ("tacotron", "tp")  # in a second JAX process


def _jax_side(names, inp) -> dict:
    """JAX's results of the jobs `names`, on the 8 virtual devices (a
    spawned helper sees them too: it inherits XLA_FLAGS)."""
    return {name: JAX_JOBS[name](inp) for name in names}


def _jax_helper(path: str, queue) -> None:
    try:
        inp = pickle.loads(pathlib.Path(path).read_bytes())
        queue.put(("jax", _jax_side(HELPER_JOBS, inp)))
    except BaseException:
        import traceback
        queue.put(("jax", traceback.format_exc()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, JAX's results, {rank: the worker's results})."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = _inputs(tmp)
    # the processes read their inputs from a file: a spawn start blocks
    # while its child imports the target's module, and large arguments
    # would make the starts wait on each other's imports
    path = tmp / "inputs.pkl"
    path.write_bytes(pickle.dumps(inp))
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, str(tmp / "store"), str(path),
                               queue), daemon=True) for r in range(WORLD)]
    procs.append(ctx.Process(target=_jax_helper, args=(str(path), queue),
                             daemon=True))
    for p in procs:
        p.start()
    try:
        ref = _jax_side([k for k in JAX_JOBS if k not in HELPER_JOBS], inp)
        ranks = {}
        deadline = time.monotonic() + BUDGET_S
        while len(ranks) < WORLD + 1:
            try:
                rank, out = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                assert not dead and time.monotonic() < deadline, \
                    f"processes exited {dead} without a result"
                continue
            if isinstance(out, str):
                raise AssertionError(f"rank {rank} failed:\n{out}")
            ranks[rank] = out
        ref.update(ranks.pop("jax"))
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive() and p.exitcode == 0, p.exitcode
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    return inp, ref, ranks


def _global_rel(got: dict, want: dict) -> float:
    """|got - want| / |want| over every tensor of the port's gradients
    (JAX's tree may hold more leaves: the port keeps the pitch statistics
    as buffers)."""
    assert set(got) <= set(want), set(got) - set(want)
    diff = np.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2))
                       for k in got))
    norm = np.sqrt(sum(float(np.sum(want[k] ** 2)) for k in got))
    return diff / norm


def _loss_rel(got: dict, want: dict) -> float:
    return max(abs(got[k] - v) / max(abs(v), 1e-12)
               for k, v in want.items())


def _same_on_every_rank(ranks, *path):
    def get(r):
        out = ranks[r]
        for key in path:
            out = out[key]
        return out

    for r in range(1, WORLD):
        for k, v in get(0).items():
            np.testing.assert_array_equal(np.asarray(get(r)[k]),
                                          np.asarray(v), err_msg=k)


def _params_close(got: dict, want: dict, n_steps: int, lr: float = 1e-4):
    """Parameters after n_steps AdamW steps within 1e-5, but for the key
    bias of each attention layer: it adds one constant to a row of
    scores, which the softmax cancels, so its gradient is rounding noise
    that Adam turns into steps of up to lr; those elements are held to
    2 lr a step (as `test_torch_port_train.py` holds them)."""
    d = TINY["enc_d_head"]      # one head: q | k | v
    for k, v in want.items():
        noise = np.zeros(v.shape, bool)
        if k.endswith("dec_attn.qkv_net.bias"):
            noise[d:2 * d] = True
            assert np.abs(got[k] - v)[noise].max() <= n_steps * 2 * lr
        np.testing.assert_allclose(got[k][~noise], v[~noise], atol=1e-5,
                                   rtol=0, err_msg=k)


# --- test_runtime.py ----------------------------------------------------------

def test_data_parallel_step_psum(world):
    _, ref, ranks = world
    loss, grad = ref["psum"]
    for r in range(WORLD):
        got = ranks[r]["psum"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
        np.testing.assert_allclose(got["grad"], grad, rtol=1e-6)
        assert got["rows"] == slice(2 * r, 2 * r + 2)


def test_pad_batch_to_devices(world):
    padded = world[2][0]["psum"]["padded"]
    assert padded.shape == (8, 3) and padded[5:].sum() == 0


def test_data_parallel_inference_matches_single(world):
    """FastPitch2Wave(mesh=) over 4 ranks: every rank returns the whole
    batch, within 1e-6 of the one-process pipeline's, at a batch that
    divides the mesh (8) and one padded up to it (3), int16 and mel out,
    one utterance; and the lengths and waves of JAX's DP call."""
    _, ref, ranks = world
    for r in range(WORLD):
        out = ranks[r]["dp_serving"]
        for label in ("b8", "b3", "int16", "mel"):
            dp, single = out[label]
            assert len(dp) == len(single) == len(TEXTS)
            for a, b in zip(dp, single):
                assert a.shape == b.shape and a.dtype == b.dtype
                tol = 1 if label == "int16" else 1e-6
                np.testing.assert_allclose(a.astype(np.float64), b, atol=tol,
                                           rtol=0, err_msg=label)
        a, b = out["single"]
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for got, want in zip(ranks[0]["dp_serving"]["b8"][0], ref["serving"]):
        assert got.shape == want.shape
        snr = 10 * np.log10(np.mean(want ** 2)
                            / (np.mean((want - got) ** 2) + 1e-20))
        assert snr > 50.0, snr


@pytest.mark.parametrize("case", ["divisible", "ragged", "short", "vocos",
                                  "2d", "two"])
def test_sp_vocode_matches_full_call(world, case):
    """The split call against the one-device call of the same generator
    (2e-6; the short one falls back to it exactly), on every rank of its
    mesh; the 2-D one also against JAX's split call (within 2e-4: the two
    generators' float32 rounding; the port's generator is held against
    JAX's in `test_torch_port_hifigan.py`)."""
    _, ref, ranks = world
    holders = [0, 1] if case == "two" else range(WORLD)
    for r in holders:
        got, full = ranks[r]["sp"][case]
        assert got.shape == full.shape
        np.testing.assert_allclose(got, full, atol=2e-6, rtol=0)
        if case == "short":
            np.testing.assert_array_equal(got, full)
        if case in ref["sp"]:
            np.testing.assert_allclose(got, ref["sp"][case], atol=2e-4,
                                       rtol=0)
    if case == "two":
        assert "two" not in ranks[2]["sp"] and "two" not in ranks[3]["sp"]
    if case == "2d":
        for r in range(WORLD):
            assert "not divisible" in ranks[r]["sp"]["2d_error"]


# --- test_tp.py ---------------------------------------------------------------

def test_tp_shardings_touch_only_the_ffn_pair(world):
    split = world[2][0]["tp"]["split"]
    # 2 enc + 2 dec FFN blocks x {conv1 weight, conv1 bias, conv2 weight}
    assert len(split) == 12, sorted(split)
    for k, d in split.items():
        assert ".pos_ff.CoreNet." in k
        assert d == (1 if ".CoreNet.2." in k else 0)
    # the hidden dim is split: each rank holds a 64 / 2 slice of conv1
    assert world[2][0]["tp"]["conv1_shape"] == (32, 32, 3)


def test_mesh_dp_tp_rejects_too_few_devices(world):
    assert "needs 16 devices" in world[2][0]["tp"]["too_few"]


def test_tp_one_all_reduce_per_ffn_and_no_hidden_gather(world):
    n_ffn = TP_CFG["enc_n_layers"] + TP_CFG["dec_n_layers"]
    for r in range(WORLD):
        calls = world[2][r]["tp"]["collectives"]
        reduces = [s for op, s in calls if op == "all_reduce"]
        assert n_ffn <= len(reduces) <= n_ffn + 1, calls
        # the reduced tensor is conv2's output (d_model), never d_inner
        assert all(s[-1] == TP_CFG["d_model"] for s in reduces), reduces
        gathers = [s for op, s in calls if op == "all_gather"]
        assert len(gathers) == 2 and gathers[0][0] == 2, calls


def test_tp_infer_matches_single_device_and_jax(world):
    _, ref, ranks = world
    mel_jax, lens_jax = ref["tp"]
    for r in range(WORLD):
        got = ranks[r]["tp"]
        np.testing.assert_array_equal(got["lens"], got["ref_lens"])
        np.testing.assert_allclose(got["mel"], got["ref_mel"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_array_equal(got["lens"], lens_jax)
        np.testing.assert_allclose(got["mel"], mel_jax, rtol=2e-4,
                                   atol=2e-5)


# --- test_parallel_multiprocess.py -------------------------------------------

def test_two_rank_dp_step_matches_one_process(world):
    ranks = world[2]
    assert ranks[0]["multiprocess"]["loss"] == \
        ranks[1]["multiprocess"]["loss"]
    assert ranks[2]["multiprocess"] is None
    np.testing.assert_allclose(ranks[0]["multiprocess"]["loss"],
                               ranks[0]["multiprocess"]["single"], rtol=2e-4)


# --- the traps of exactness -------------------------------------------------

def test_dp_fastpitch_step_with_unequal_lengths_matches_jax(world):
    """Each rank holds one row of its own lengths: the DP step's loss
    terms and gradients are JAX's global ones; the naive DDP step (each
    rank's own mean, gradients averaged) misses them."""
    _, ref, ranks = world
    want_meta, want_grads = ref["fastpitch"]
    _same_on_every_rank(ranks, "fastpitch_dp", "meta")
    _same_on_every_rank(ranks, "fastpitch_dp", "grads")
    got = ranks[0]["fastpitch_dp"]
    assert _loss_rel({k: got["meta"][k] for k in want_meta},
                     want_meta) <= LOSS_TOL
    assert _global_rel(got["grads"], want_grads) <= GRAD_TOL
    assert float(got["meta"]["grad_norm"]) == pytest.approx(
        np.sqrt(sum(float(np.sum(want_grads[k] ** 2)) for k in got["grads"])),
        rel=1e-4)
    assert _loss_rel(got["naive_meta"], want_meta) > LOSS_TOL
    assert _global_rel(got["naive_grads"], want_grads) > GRAD_TOL


def test_dp_tacotron2_step_takes_global_batch_statistics(world):
    _, ref, ranks = world
    want_meta, want_grads, want_stats = ref["tacotron"]
    _same_on_every_rank(ranks, "tacotron_dp", "stats")
    got = ranks[0]["tacotron_dp"]
    assert _loss_rel({k: got["meta"][k] for k in want_meta},
                     want_meta) <= LOSS_TOL
    assert _global_rel(got["grads"], want_grads) <= GRAD_TOL
    for k, v in want_stats.items():
        np.testing.assert_allclose(got["stats"][k], v, atol=1e-6, rtol=0,
                                   err_msg=k)
    naive = max(float(np.abs(got["naive_stats"][k] - v).max())
                for k, v in want_stats.items() if "running_var" in k)
    assert naive > 1e-6, naive


def test_dp_clip_sees_the_global_gradient(world):
    """clip_by_global_norm of JAX's global gradient; the naive version
    clips each rank's share before the sum."""
    _, ref, ranks = world
    got = ranks[0]["fastpitch_dp"]
    g = {k: ref["fastpitch"][1][k] for k in got["clip_grads"]}
    norm = np.sqrt(sum(float(np.sum(v ** 2)) for v in g.values()))
    assert norm > 10 * CLIP
    want = {k: v * (CLIP / norm) for k, v in g.items()}
    assert got["clip_meta"]["grad_norm"] == pytest.approx(norm, rel=1e-4)
    assert _global_rel(got["clip_grads"], want) <= GRAD_TOL
    assert _global_rel(got["naive_clip_grads"], want) > GRAD_TOL


def test_dp_adversarial_step_matches_one_process(world):
    """The critic under DP: chunks drawn over the global batch (a rank may
    score none), its step on the summed gradient; model, critic and
    vectors after the step equal on every rank and within 1e-5 of one
    process's step."""
    ranks = world[2]
    assert sorted(ranks[r]["adversarial_dp"]["chunks_here"]
                  for r in range(WORLD))[0] == 0
    for part in ("meta", "model", "critic", "spectral"):
        _same_on_every_rank(ranks, "adversarial_dp", "dp", part)
    got = ranks[0]["adversarial_dp"]
    single = got["single"]
    assert _loss_rel(got["dp"]["meta"], single["meta"]) <= LOSS_TOL
    _params_close(got["dp"]["model"], single["model"], 1)
    for part in ("critic", "spectral"):
        for k, v in single[part].items():
            np.testing.assert_allclose(got["dp"][part][k], v, atol=1e-5,
                                       rtol=0, err_msg=f"{part}: {k}")


def test_dp_vocoder_step_matches_one_process(world):
    ranks = world[2]
    got = ranks[0]["vocoder_dp"]
    for r in range(1, WORLD):
        for k, v in got["gen"].items():
            np.testing.assert_array_equal(ranks[r]["vocoder_dp"]["gen"][k],
                                          v)
    assert _loss_rel(got["meta"], got["single_meta"]) <= LOSS_TOL
    for k, v in got["single_gen"].items():
        np.testing.assert_allclose(got["gen"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


def test_trainer_with_a_mesh(world):
    """Trainer(mesh=): two DP steps, rank 0 alone logs and checkpoints,
    every rank ends with one process's parameters (1e-5), and a restore
    on every rank reads rank 0's checkpoint."""
    ranks = world[2]
    assert ranks[0]["trainer"]["wrote"] == ["states.ckpt"]
    assert ranks[0]["trainer"]["logs"]
    _same_on_every_rank(ranks, "trainer", "params")
    for r in range(WORLD):
        got = ranks[r]["trainer"]
        assert got["step"] == 2 and got["restored_step"] == 2
        assert got["logger"] == (r == 0)
        for k, v in got["params"].items():
            np.testing.assert_array_equal(got["restored"][k], v)
    _params_close(ranks[0]["trainer"]["params"],
                  ranks[0]["trainer"]["single"], 2)


def test_port_exports_the_jax_packages_parallel_names():
    from tts_arabic_torch import parallel
    assert set(jp.__all__) <= set(parallel.__all__), \
        set(jp.__all__) - set(parallel.__all__)
    for name in jp.__all__:
        assert getattr(parallel, name) is not None
    assert (parallel.DATA_AXIS, parallel.SEQ_AXIS, parallel.MODEL_AXIS) == \
        (jp.DATA_AXIS, jp.SEQ_AXIS, jp.MODEL_AXIS)
