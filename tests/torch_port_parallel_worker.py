"""The ranks of `tests/test_torch_port_parallel.py`: one process of a gloo
world on the CPU, spawned by the test module (no JAX here). `run` joins the
group through a FileStore, runs every case of `CASES` in order (each rank
builds every case's meshes, since making a process group is collective),
and puts (rank, {case: result}) or (rank, traceback) on the queue. Results
are numpy arrays and plain Python values."""
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tts_arabic_torch.parallel import (DATA_AXIS, SEQ_AXIS, all_reduce,
                                       all_reduce_grads, data_parallel_jit,
                                       fastpitch_tp_shardings, global_total,
                                       init_multiprocess, make_mesh,
                                       make_mesh_2d, make_mesh_dp_tp,
                                       pad_batch_to_devices,
                                       process_local_rows, shard_batch,
                                       sp_vocode, tp_mel_infer_jit)

COLLECTIVE_TIMEOUT = 120.0  # seconds; a failed rank must not hang the test


def _np(t):
    return t.detach().cpu().numpy()


def _grads(model) -> dict:
    return {n: _np(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


def _meta(meta) -> dict:
    return {k: float(v) for k, v in meta.items()}


def case_psum(rank, inp):
    """test_runtime's DP psum step: the global mean loss and its gradient
    from each rank's two rows."""
    mesh = make_mesh()
    w = torch.tensor(inp["psum_w"], requires_grad=True)

    def step_fn(params, b):
        x, y = (torch.as_tensor(b[k]) for k in ("x", "y"))
        sq = (x @ params - y) ** 2
        loss = sq.sum() / global_total(mesh)(torch.tensor(float(sq.numel())))
        loss.backward()
        all_reduce_grads([params], mesh)
        return all_reduce(loss.detach(), mesh)

    loss = data_parallel_jit(step_fn, mesh)(w, inp["psum_batch"])
    padded = pad_batch_to_devices({"x": np.ones((5, 3))}, mesh)["x"]
    return dict(loss=float(loss), grad=_np(w.grad), padded=padded,
                rows=process_local_rows(8, mesh))


def _pipe(inp, mesh=None):
    from tts_arabic_torch.infer import FastPitch2Wave
    fp, voc, voc_json = inp["pipe_weights"]
    return FastPitch2Wave(fp, voc, voc_json, arabic_in=False, device="cpu",
                          mesh=mesh)


def case_dp_serving(rank, inp):
    """FastPitch2Wave(mesh=) of 4 ranks and the one-process pipeline on the
    same 8 texts: tts() at batch 8 (2 rows a rank) and at batch 3 (rows
    padded to 4), int16 out, ttmel, tts_single, warmup."""
    mesh = make_mesh()
    dp, single = _pipe(inp, mesh), _pipe(inp)
    texts = inp["texts"]
    dp.warmup(batch_sizes=(2,), text_buckets=(16,), mel_buckets=(64,),
              denoise=0.003)
    out = {}
    for label, kw in (("b8", dict(batch_size=8, denoise=0.003)),
                      ("b3", dict(batch_size=3, denoise=0.003)),
                      ("int16", dict(batch_size=8, denoise=0.003,
                                     out_int16=True))):
        out[label] = (dp.tts(texts, **kw), single.tts(texts, **kw))
    out["mel"] = (dp.model.ttmel(texts, batch_size=8),
                  single.model.ttmel(texts, batch_size=8))
    out["single"] = (dp.tts(texts[2], denoise=0.003),
                     single.tts(texts[2], denoise=0.003))
    return out


def _generator(sd, cfg):
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    gen = Generator(HiFiGANConfig(**cfg))
    gen.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    return gen.eval()


def case_sp(rank, inp):
    """The six sp_vocode cases of test_runtime.py on 4 ranks (n = 2: ranks
    0-1): the split call and the one-device call of the same generator."""
    from tts_arabic_torch.vocoder.vocos import (MelVocosModule,
                                                load_vocos_state)
    mesh, mesh2d, mesh2 = make_mesh(), make_mesh_2d(2, 2), make_mesh(2)
    gen = _generator(inp["gen_sd"], inp["gen_cfg"])
    vocos = MelVocosModule(**inp["vocos_cfg"])
    load_vocos_state(vocos, {k: torch.tensor(v)
                             for k, v in inp["vocos_sd"].items()})
    vocos.eval()
    out = {}
    with torch.no_grad():
        for name, (fn, mel, m, kw) in {
                "divisible": (gen, "mel_div", mesh, {}),
                "ragged": (gen, "mel_ragged", mesh, {}),
                "short": (gen, "mel_short", mesh, {}),
                "vocos": (vocos, "mel_vocos", mesh, dict(overlap=32)),
                "2d": (gen, "mel_2d", mesh2d,
                       dict(axis=SEQ_AXIS, batch_axis=DATA_AXIS)),
                "two": (gen, "mel_two", mesh2, {})}.items():
            if m.coords is None:
                continue
            x = torch.tensor(inp[mel])
            out[name] = (_np(sp_vocode(fn, x, m, **kw)), _np(fn(x)))
        try:
            sp_vocode(gen, torch.tensor(inp["mel_2d"][:3]), mesh2d,
                      axis=SEQ_AXIS, batch_axis=DATA_AXIS)
        except ValueError as e:
            out["2d_error"] = str(e)
    return out


def case_tp(rank, inp):
    """tp_mel_infer_jit on a 2 x 2 (data x model) mesh against the
    one-device infer; the split keys; too few ranks."""
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    try:
        make_mesh_dp_tp(4, 4)
        too_few = None
    except ValueError as e:
        too_few = str(e)
    mesh = make_mesh_dp_tp(2, 2)
    model = FastPitch(FastPitchConfig(**inp["tp_cfg"]))
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in inp["tp_sd"].items()})
    model.eval()
    tokens = torch.tensor(inp["tp_tokens"])
    fn, sharded = tp_mel_infer_jit(model, mesh, max_frames=64)
    mel, lens = fn(sharded, tokens)
    with torch.no_grad():
        ref = model.infer(tokens, max_frames=64)
    split = fastpitch_tp_shardings(model.state_dict(), mesh)
    conv1 = sharded.encoder.layers[0].pos_ff.conv1.weight
    return dict(mel=_np(mel), lens=_np(lens), ref_mel=_np(ref["mel"]),
                ref_lens=_np(ref["mel_lens"]),
                split={k: d for k, d in split.items() if d is not None},
                collectives=list(sharded.collectives),
                conv1_shape=tuple(conv1.shape), too_few=too_few)


def _fastpitch(inp, key="fp_sd", cfg="fp_cfg"):
    from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
    model = FastPitch(FastPitchConfig(**inp[cfg]))
    model.load_state_dict({k: torch.tensor(v) for k, v in inp[key].items()})
    return model


def _fastpitch_backward(model, local, total=None):
    """The train step's forward and backward on this rank's rows, its loss
    terms divided by the local denominators (`total` None: the naive DDP
    step's) or the global ones; returns the meta."""
    from tts_arabic_torch.align.mas import mas_durations
    from tts_arabic_torch.train import losses
    from tts_arabic_torch.train.steps import batch_to_device
    b = batch_to_device(local, "cpu")
    with torch.no_grad():
        soft, _ = model.align_attention(b["tokens"], b["mel_tgt"],
                                        b["attn_prior"])
    hard, durs = mas_durations(soft, b["token_lens"], b["mel_lens"])
    out = model.forward_train(b["tokens"], b["token_lens"], b["mel_tgt"],
                              b["mel_lens"], b["pitch_dense"],
                              b["energy_dense"], b["attn_prior"], durs)
    loss, meta = losses.fastpitch_loss(out, b, total)
    kl = losses.attention_binarization_loss(hard, out["attn_soft"], total)
    meta["kl_loss"] = kl
    (loss + kl).backward()
    return meta


def case_fastpitch_dp(rank, inp):
    """A DP FastPitch step whose 4 ranks hold unequal lengths (one row
    each): its meta and gradients; the naive DDP version's; a clipped DP
    step's gradients after the clip and the naive clip-then-sum's."""
    from tts_arabic_torch.train import steps
    mesh = make_mesh()
    batch = inp["fp_batch"]
    step = data_parallel_jit(steps.make_fastpitch_train_step(device="cpu"),
                             mesh)
    model = _fastpitch(inp)
    state = steps.TrainState(model, steps.make_optimizer(model, 1e-4))
    out = dict(meta=_meta(step(state, batch, 0)), grads=_grads(model))

    model = _fastpitch(inp)
    meta = _fastpitch_backward(model, shard_batch(batch, mesh))
    n = mesh.axis_size(DATA_AXIS)
    out["naive_meta"] = {k: float(all_reduce(v.detach(), mesh)) / n
                         for k, v in meta.items()}
    all_reduce_grads(list(model.parameters()), mesh)
    out["naive_grads"] = {k: v / n for k, v in _grads(model).items()}

    clip = inp["clip"]
    model = _fastpitch(inp)
    state = steps.TrainState(model, steps.make_optimizer(model, 1e-4,
                                                         grad_clip=clip))
    out["clip_meta"] = _meta(step(state, batch, 0))
    out["clip_grads"] = _grads(model)
    # naive: each rank clips its own share before the sum
    model = _fastpitch(inp)
    _fastpitch_backward(model, shard_batch(batch, mesh), global_total(mesh))
    steps.clip_by_global_norm([p.grad for p in model.parameters()
                               if p.grad is not None], clip)
    all_reduce_grads(list(model.parameters()), mesh)
    out["naive_clip_grads"] = _grads(model)
    return out


def case_tacotron_dp(rank, inp):
    """A DP Tacotron2 step over 4 ranks (one row each, BatchNorm's
    statistics over the global batch; dropout off): meta, gradients,
    running statistics; the naive version's statistics (each rank's own,
    averaged)."""
    from tts_arabic_torch.models import tacotron2 as t2
    from tts_arabic_torch.train import steps
    t2.Tacotron2._dropout = lambda self, x, rate, gen: x
    mesh = make_mesh()
    batch = inp["t2_batch"]

    def model_():
        model = t2.Tacotron2(t2.Tacotron2Config(**inp["t2_cfg"]))
        model.load_state_dict({k: torch.tensor(v)
                               for k, v in inp["t2_sd"].items()})
        return model

    model = model_()
    state = steps.TrainState(model, steps.make_optimizer(model, 1e-3,
                                                         grad_clip=1e9))
    step = data_parallel_jit(steps.make_tacotron_train_step(device="cpu"),
                             mesh)
    out = dict(meta=_meta(step(state, batch, 0)), grads=_grads(model),
               stats={k: _np(v) for k, v in model.state_dict().items()
                      if "running" in k})
    model = model_()
    b = steps.batch_to_device(shard_batch(batch, mesh), "cpu")
    model.train()
    model.forward_train(b["tokens"], b["token_lens"], b["mel_tgt"],
                        b["mel_lens"])
    n = mesh.axis_size(DATA_AXIS)
    out["naive_stats"] = {k: _np(all_reduce(v, mesh)) / n
                          for k, v in model.state_dict().items()
                          if "running" in k}
    return out


def case_multiprocess(rank, inp):
    """test_parallel_multiprocess: a 2-rank DP FastPitch step of 8 rows
    against one process's step on them (ranks 0-1; rank 0 runs both)."""
    from tts_arabic_torch.train import steps
    mesh = make_mesh(2)
    if mesh.coords is None:
        return None
    batch = inp["mp_batch"]

    def state_():
        model = _fastpitch(inp, "mp_sd", "mp_cfg")
        return steps.TrainState(model, steps.make_optimizer(model, 1e-4))

    step = steps.make_fastpitch_train_step(device="cpu")
    dp = data_parallel_jit(step, mesh)(state_(), batch, 0)
    out = dict(loss=float(dp["loss"]))
    if rank == 0:
        out["single"] = float(step(state_(), batch, 0)["loss"])
    return out


def case_adversarial_dp(rank, inp):
    """The adversarial FastPitch step on 4 ranks against one process's on
    the same global batch and chunks: meta, the model, the critic and its
    vectors after the step (a rank may score no chunk)."""
    from tts_arabic_torch.train import gan, steps
    mesh = make_mesh()
    batch, chunks = inp["fp_batch"], inp["adv_chunks"]

    def state_():
        model = _fastpitch(inp)
        critic = gan.PatchDiscriminator(8)
        spectral = gan.init_critic(critic, 1)
        return steps.TrainState(model, steps.make_optimizer(model, 1e-4),
                                critic=critic,
                                d_optimizer=steps.make_optimizer(critic,
                                                                 1e-4),
                                spectral=spectral)

    step = steps.make_fastpitch_train_step(device="cpu")

    def result(state, meta):
        return dict(meta=_meta(meta),
                    model={k: _np(v) for k, v in
                           state.model.state_dict().items()},
                    critic={k: _np(v) for k, v in
                            state.critic.state_dict().items()},
                    spectral={k: _np(v) for k, v in state.spectral.items()})

    state = state_()
    out = dict(dp=result(state, data_parallel_jit(step, mesh)(
        state, batch, 0, chunks=chunks)))
    n_mine = int(np.sum((chunks[0] >= rank) & (chunks[0] < rank + 1)))
    out["chunks_here"] = n_mine
    if rank == 0:
        state = state_()
        out["single"] = result(state, step(state, batch, 0, chunks=chunks))
    return out


def case_vocoder_dp(rank, inp):
    """HiFi-GAN vocoder training, one step on 4 ranks (a crop each) against
    one process's step on the 4 crops."""
    from tts_arabic_torch.train import vocoder
    from tts_arabic_torch.vocoder import discriminators as disc
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    mesh = make_mesh()

    def state_():
        return vocoder.init_vocoder_state(
            Generator(HiFiGANConfig(**inp["gen_cfg"])),
            disc.MultiPeriodDiscriminator((2,), 0.125),
            disc.MultiScaleDiscriminator(1, 0.125), seed=0, device="cpu")

    step = vocoder.make_hifigan_train_step(device="cpu")
    batch = {"wave": inp["waves"]}
    state = state_()
    out = dict(meta=_meta(data_parallel_jit(step, mesh)(state, batch)),
               gen={k: _np(v) for k, v in state.model.state_dict().items()})
    if rank == 0:
        state = state_()
        out["single_meta"] = _meta(step(state, batch))
        out["single_gen"] = {k: _np(v)
                             for k, v in state.model.state_dict().items()}
    return out


class _Batches:
    """Whole collated batches, as `DynBatchDataset` yields them."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, i):
        return self.batches[i]


def case_trainer(rank, inp):
    """Trainer(mesh=) for 2 steps on 4 ranks: only rank 0 logs and writes;
    every rank ends with rank 0's parameters, equal to one process's run;
    a restore on every rank reads rank 0's checkpoint."""
    import pathlib

    from tts_arabic_torch.train import steps
    from tts_arabic_torch.train.trainer import Trainer
    mesh = make_mesh()
    root = pathlib.Path(inp["trainer_dir"])
    data = _Batches([inp["fp_batch"], inp["fp_batch2"]])

    def trainer_(sub, mesh):
        model = _fastpitch(inp)
        state = steps.TrainState(model, steps.make_optimizer(model, 1e-4))
        return Trainer(steps.make_fastpitch_train_step(device="cpu"), state,
                       log_dir=root / sub / "logs",
                       checkpoint_dir=root / sub / "ckpt",
                       n_save_states_iter=1, device="cpu", mesh=mesh)

    tr = trainer_("dp", mesh)
    tr.fit(data, lambda b: b, epochs=1, log_every=1)
    tr.close()
    dist.barrier()
    params = {k: _np(v) for k, v in tr.state.model.state_dict().items()}
    out = dict(params=params, step=tr.state.step,
               logs=(root / "dp" / "logs").exists(),
               logger=tr.logger is not None,
               wrote=sorted(p.name for p in (root / "dp" / "ckpt").glob("*"))
               if rank == 0 else None)
    # a fresh Trainer on every rank restores rank 0's checkpoint
    fresh = trainer_("dp", mesh)
    out["restored_step"] = fresh.restore()
    out["restored"] = {k: _np(v)
                       for k, v in fresh.state.model.state_dict().items()}
    fresh.close()
    if rank == 0:
        single = trainer_("single", None)
        single.fit(data, lambda b: b, epochs=1, log_every=1)
        single.close()
        out["single"] = {k: _np(v) for k, v in
                         single.state.model.state_dict().items()}
    return out


CASES = [("psum", case_psum), ("tp", case_tp), ("sp", case_sp),
         ("fastpitch_dp", case_fastpitch_dp),
         ("tacotron_dp", case_tacotron_dp),
         ("multiprocess", case_multiprocess),
         ("adversarial_dp", case_adversarial_dp),
         ("vocoder_dp", case_vocoder_dp), ("trainer", case_trainer),
         ("dp_serving", case_dp_serving)]


def run(rank: int, world: int, init_file: str, inputs: str,
        queue) -> None:
    """Rank `rank` of `world`: the cases' inputs from the pickle file
    `inputs` (written by the test module), the results on `queue`."""
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        torch.set_num_threads(1)
        # TensorBoard's first import takes seconds; the Trainer logs to
        # its JSONL file without it
        sys.modules["torch.utils.tensorboard"] = None
        init_multiprocess(f"file://{init_file}", world, rank, "gloo",
                          timeout=COLLECTIVE_TIMEOUT)
        out = {}
        for name, case in CASES:
            torch.manual_seed(0)
            out[name] = case(rank, inp)
        queue.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def run_cuda(rank: int, world: int, init_file: str, queue) -> None:
    """Rank `rank` of a gloo world whose ranks share cuda:0 (NCCL refuses
    two ranks on one GPU): sp_vocode of a seeded HiFi-GAN V1 in f32 and
    bf16, and a DP FastPitch step with MAS on the kernel, each against
    the one-process call on the card; puts (rank, results) or (rank,
    traceback) on the queue."""
    try:
        from tts_arabic_torch.ops import mas as mas_ops
        from tts_arabic_torch.ops import resblock as rb
        from tts_arabic_torch.models.fastpitch import (FastPitch,
                                                       FastPitchConfig)
        from tts_arabic_torch.models.layers import init_weights
        from tts_arabic_torch.train import steps
        from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        init_multiprocess(f"file://{init_file}", world, rank, "gloo",
                          timeout=COLLECTIVE_TIMEOUT)
        mesh = make_mesh()
        out = {}
        gen = init_weights(Generator(HiFiGANConfig()), 1).cuda().eval()
        g = torch.Generator().manual_seed(0)
        mel = (torch.randn((1, 300, 80), generator=g) - 5.0).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = mel.to(dtype)
            with torch.no_grad():
                rb.reset_launches()
                got = sp_vocode(gen, x, mesh).float()
                launches = dict(rb.LAUNCHES)
                full = gen(x).float()
            out[str(dtype)] = (_np(got), _np(full), launches)
        cfg = FastPitchConfig(d_model=32, enc_n_layers=1, dec_n_layers=1,
                              enc_d_head=8, dec_d_head=8, enc_filter_size=64,
                              dec_filter_size=64, dur_filter_size=16,
                              pitch_filter_size=16, energy_filter_size=16,
                              attn_channels=8, **{
                                  f: 0.0 for f in FastPitchConfig.__dataclass_fields__
                                  if "drop" in f})
        rng = np.random.default_rng(0)
        B, T_txt, T_mel = 4, 12, 96
        token_lens = np.array([12, 9, 7, 10], np.int32)
        mel_lens = np.array([96, 70, 60, 80], np.int32)
        batch = {"tokens": rng.integers(1, 40, (B, T_txt)).astype(np.int32),
                 "token_lens": token_lens,
                 "mel_tgt": rng.standard_normal((B, T_mel, 80)).astype(
                     np.float32) - 4.0,
                 "mel_lens": mel_lens,
                 "pitch_dense": rng.standard_normal((B, 1, T_mel)).astype(
                     np.float32),
                 "energy_dense": np.abs(rng.standard_normal(
                     (B, T_mel))).astype(np.float32),
                 "attn_prior": np.full((B, T_mel, T_txt), 1.0 / T_txt,
                                       np.float32)}
        for i, (nt, nm) in enumerate(zip(token_lens, mel_lens)):
            batch["tokens"][i, nt:] = 0
            batch["mel_tgt"][i, nm:] = 0.0

        def state_():
            model = init_weights(FastPitch(cfg), 0).cuda()
            return steps.TrainState(model, steps.make_optimizer(model))

        step = steps.make_fastpitch_train_step(device="cuda")
        mas_ops.reset_launches()
        dp = data_parallel_jit(step, mesh)(state_(), batch, 0)
        out["mas_launches"] = mas_ops.LAUNCHES["mas"]
        out["dp"] = _meta(dp)
        if rank == 0:
            out["single"] = _meta(step(state_(), batch, 0))
        queue.put((rank, out))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, traceback.format_exc()))
