"""Train and eval steps for FastPitch and Tacotron2, MSE and adversarial
(the port's counterpart of the JAX package's `train/steps.py`; reference
`scripts/train_{fp,fp_adv,tc2,tc2_adv}.py`).

- FastPitch: soft ConvAttention -> MAS on the card (`align.mas_durations`,
  the CUDA kernel of `ops/mas.py` for CUDA tensors) -> teacher-forced
  forward with the hard durations -> composite loss + binarization KL.
- Tacotron2: the teacher-forced training forward -> mel, postnet-mel and
  gate loss; BatchNorm's running statistics move in the model's buffers.
- The adversarial recipe adds an LSGAN critic on random 128-frame mel
  chunks (`train/gan.py`). The critic's update comes first: it sees the
  real chunks and the generator's chunks from a no-grad forward with the
  same dropout masks; the generator's loss then asks the UPDATED critic,
  with the critic's feature maps of the real chunks taken before its
  update (the reference's optimizer order, `train_fp_adv.py:144-169`).

Then backward -> global-norm clip -> AdamW, float32 throughout, as the JAX
steps are. A step's dropout masks come from a generator on the device
seeded by (seed, step), its chunk ids and offsets from another on the CPU,
so a step can be replayed exactly and the card draws the CPU's chunks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..align.mas import mas_durations
from ..eval.alignment import alignment_diagnostics
from ..runtime.device import resolve_device
from .gan import (CHUNK_LEN, PatchDiscriminator, critic_input,
                  feature_match_loss, init_critic, sample_chunk_params)
from .losses import (attention_binarization_loss, fastpitch_loss,
                     tacotron2_loss)

GRAD_CLIP = 1000.0      # global-norm clip of the FastPitch and critic recipes
CRITIC_CNUM = 32        # the reference's PatchDiscriminator(1, 32)
_CHUNK_STREAM = 1 << 63  # keeps the chunk generator's seeds apart


class ClippedAdamW(torch.optim.AdamW):
    """AdamW behind a global-norm clip: optax's
    `chain(clip_by_global_norm(grad_clip), adamw(...))`."""

    def __init__(self, params, *, grad_clip: float, **kw):
        super().__init__(params, **kw)
        self.grad_clip = grad_clip

    def clip_and_step(self) -> torch.Tensor:
        """Clip the gradients by their global norm, take the AdamW step;
        returns the norm before the clip."""
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        norm = clip_by_global_norm(grads, self.grad_clip)
        self.step()
        return norm


def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """optax's `clip_by_global_norm`, in place: above `max_norm` every
    gradient is scaled by max_norm / |g| (no eps, unlike
    `torch.nn.utils.clip_grad_norm_`). Returns |g|, with no host sync."""
    norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and, for Tacotron2, BatchNorm's running
    statistics in its buffers), its optimizer and the count of updates
    taken; for the adversarial recipe also the critic, its optimizer and
    its power-iteration vectors (`spectral`, {'conv<i>': u}). The step
    functions update all of them in place."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    critic: Optional[torch.nn.Module] = None
    d_optimizer: Optional[torch.optim.Optimizer] = None
    spectral: Optional[dict] = None


def make_optimizer(model: torch.nn.Module, lr=1e-4, beta1=0.9, beta2=0.999,
                   weight_decay=1e-6, grad_clip=GRAD_CLIP) -> ClippedAdamW:
    """AdamW over the model's parameters behind a global-norm clip
    (reference recipe: 1000 for FastPitch and the critic, the config's
    `grad_clip_thresh` for Tacotron2). Decoupled decay, eps 1e-8, as
    optax's `adamw`. The corpus pitch statistics are buffers here, so they
    are not decayed; the JAX package holds them as parameters and decays
    them by lr * wd per step."""
    return ClippedAdamW(model.parameters(), grad_clip=grad_clip, lr=lr,
                        betas=(beta1, beta2), eps=1e-8,
                        weight_decay=weight_decay)


def add_critic(state: TrainState, config, seed: int, device) -> None:
    """Give `state` the adversarial recipe's critic: a seeded
    `PatchDiscriminator(32)` with its iteration vectors, on `device`, and
    its AdamW (clip 1000) from the config's `d_lr`, `d_beta1`, `d_beta2`
    and `weight_decay`."""
    critic = PatchDiscriminator(CRITIC_CNUM)
    spectral = init_critic(critic, seed)
    state.critic = critic.to(device)
    state.spectral = {k: v.to(device) for k, v in spectral.items()}
    state.d_optimizer = make_optimizer(
        critic, config.d_lr, config.d_beta1, config.d_beta2,
        config.get("weight_decay", 1e-6))


def batch_to_device(batch: dict, device) -> dict:
    """Collated numpy arrays -> tensors on `device` (integers as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.to(torch.long)
        out[k] = t.to(device, non_blocking=True)
    return out


def _step_seed(seed: int, step: int) -> int:
    return (int(seed) << 32) + int(step)


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout generator, seeded by (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_step_seed(seed, step))
    return gen


def chunk_generator(seed: int, step: int) -> torch.Generator:
    """The step's generator of the critic's chunk ids and offsets: on the
    CPU, seeded by (seed, step) apart from the dropout's."""
    return torch.Generator().manual_seed(_step_seed(seed, step)
                                         + _CHUNK_STREAM)


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """No gradient for `module`'s parameters inside (the generator's pass
    through the critic)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class _Critic:
    """One step's adversarial part: the chunks, the critic's update and the
    generator's terms."""

    def __init__(self, state: TrainState, batch: dict, dev, seed: int,
                 chunks):
        if chunks is None:
            lens = batch["mel_lens"]
            lens = (lens.cpu() if isinstance(lens, torch.Tensor)
                    else torch.as_tensor(np.asarray(lens)))
            chunks = sample_chunk_params(chunk_generator(seed, state.step),
                                         len(lens), lens, CHUNK_LEN)
        self.state = state
        self.mel_ids, self.ofx = (torch.as_tensor(c).to(dev, torch.long)
                                  for c in chunks)

    def update(self, mel_tgt: torch.Tensor, mel_fake: torch.Tensor) -> None:
        """The LSGAN critic step (`train_fp_adv.py:127-152`): the real and
        the fake pass both start from the state's iteration vectors, which
        then advance once; keeps the real chunks' feature maps of the
        critic before its update and the critic's loss."""
        st = self.state
        real = critic_input(mel_tgt, self.mel_ids, self.ofx)
        fake = critic_input(mel_fake.detach(), self.mel_ids, self.ofx)
        d_org, fmaps_org, spectral = st.critic(real, st.spectral)
        d_gen, _, _ = st.critic(fake, st.spectral)
        loss_d = (0.5 * torch.mean((d_org - 1.0) ** 2)
                  + 0.5 * torch.mean(d_gen ** 2))
        st.d_optimizer.zero_grad(set_to_none=True)
        loss_d.backward()
        st.d_optimizer.clip_and_step()
        st.spectral = spectral
        self.fmaps_org = [f.detach() for f in fmaps_org]
        self.loss_d = loss_d.detach()

    def generator_terms(self, mel: torch.Tensor, loss: torch.Tensor,
                        meta: dict, gan_loss_weight: float,
                        feat_loss_weight: float) -> torch.Tensor:
        """The generator's adversarial and feature-matching terms from the
        updated critic (one more power iteration, its vector discarded),
        added to `loss` and recorded in `meta`."""
        st = self.state
        with _frozen(st.critic):
            d_gen, fmaps_gen, _ = st.critic(
                critic_input(mel, self.mel_ids, self.ofx), st.spectral)
        score = torch.mean((d_gen - 1.0) ** 2)
        fmatch = feature_match_loss(fmaps_gen, self.fmaps_org)
        meta.update(score=score, fmatch=fmatch, loss_d=self.loss_d)
        return loss + gan_loss_weight * score + feat_loss_weight * fmatch


def _update(state: TrainState, loss: torch.Tensor, meta: dict) -> dict:
    """Backward, clip and AdamW for the model; returns the detached meta
    with the pre-clip gradient norm."""
    meta["loss"] = loss
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    meta["grad_norm"] = state.optimizer.clip_and_step()
    state.step += 1
    return {k: v.detach() for k, v in meta.items()}


def _fp_forward(model, b, durs, gen):
    return model.forward_train(
        b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
        b["pitch_dense"], b["energy_dense"], b["attn_prior"], durs, gen=gen)


def make_fastpitch_train_step(*, device=None, gan_loss_weight: float = 3.0,
                              feat_loss_weight: float = 1.0):
    """Returns step(state, batch, seed, chunks=None) -> meta, `batch` from
    `data.collate_fastpitch` (numpy or tensors). It updates `state` in
    place and returns the loss terms and the pre-clip gradient norm as
    0-d tensors. A state with a critic takes the adversarial recipe
    (`configs/nawar_fp_adv.yaml`'s weights by default); `chunks` = the
    critic's (mel_ids, offsets), drawn from `chunk_generator` when None.
    `device=None` means the CUDA card, which must exist."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict, seed: int = 0,
             chunks=None) -> dict:
        model = state.model
        b = batch_to_device(batch, dev)
        with torch.no_grad():
            attn_soft, _ = model.align_attention(b["tokens"], b["mel_tgt"],
                                                 b["attn_prior"])
        attn_hard, durs = mas_durations(attn_soft, b["token_lens"],
                                        b["mel_lens"])
        del attn_soft

        critic = None
        if state.critic is not None:
            critic = _Critic(state, batch, dev, seed, chunks)
            with torch.no_grad():
                fake = _fp_forward(model, b, durs, dropout_generator(
                    seed, state.step, dev))["mel_out"]
            critic.update(b["mel_tgt"], fake)
            del fake

        out = _fp_forward(model, b, durs,
                          dropout_generator(seed, state.step, dev))
        loss, meta = fastpitch_loss(out, b)
        kl = attention_binarization_loss(attn_hard, out["attn_soft"])
        loss = loss + kl
        meta["kl_loss"] = kl
        if critic is not None:
            loss = critic.generator_terms(out["mel_out"], loss, meta,
                                          gan_loss_weight, feat_loss_weight)
        return _update(state, loss, meta)

    return step


def make_fastpitch_eval_step(*, device=None):
    """Validation step (reference `validate()`, train.py:19-58): forward
    only, no dropout, no optimizer. Returns eval_step(state, batch) ->
    meta: the loss terms and the alignment diagnostics, as 0-d tensors.
    The JAX step also returns the soft attention and mels for figures,
    which the port does not draw."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        model = state.model
        b = batch_to_device(batch, dev)
        attn_soft, _ = model.align_attention(b["tokens"], b["mel_tgt"],
                                             b["attn_prior"])
        attn_hard, durs = mas_durations(attn_soft, b["token_lens"],
                                        b["mel_lens"])
        out = _fp_forward(model, b, durs, None)
        loss, meta = fastpitch_loss(out, b)
        kl = attention_binarization_loss(attn_hard, out["attn_soft"])
        meta["kl_loss"] = kl
        meta["loss"] = loss + kl
        meta.update(alignment_diagnostics(out["attn_soft"], b["mel_lens"],
                                          b["token_lens"]))
        return meta

    return eval_step


def _t2_forward(model, b, gen, update_stats=True):
    return model.forward_train(b["tokens"], b["token_lens"], b["mel_tgt"],
                               b["mel_lens"], gen=gen,
                               update_stats=update_stats)


def make_tacotron_train_step(*, device=None, gan_loss_weight: float = 4.0,
                             feat_loss_weight: float = 1.0):
    """Returns step(state, batch, seed, chunks=None) -> meta, `batch` from
    `data.collate_tacotron`. As `make_fastpitch_train_step`; the critic
    reads the postnet mel (`configs/nawar_tc2_adv.yaml`'s weights by
    default), and the model's BatchNorm statistics move once a step (the
    critic's no-grad forward leaves them)."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict, seed: int = 0,
             chunks=None) -> dict:
        model = state.model
        model.train()           # cuDNN's LSTM backward needs train mode
        b = batch_to_device(batch, dev)
        critic = None
        if state.critic is not None:
            critic = _Critic(state, batch, dev, seed, chunks)
            with torch.no_grad():
                _, fake, _, _ = _t2_forward(
                    model, b, dropout_generator(seed, state.step, dev),
                    update_stats=False)
            critic.update(b["mel_tgt"], fake)
            del fake

        mel_out, mel_post, gates, _ = _t2_forward(
            model, b, dropout_generator(seed, state.step, dev))
        loss, meta = tacotron2_loss(mel_out, mel_post, gates, b["mel_tgt"],
                                    b["gate_tgt"], b["mel_lens"])
        if critic is not None:
            loss = critic.generator_terms(mel_post, loss, meta,
                                          gan_loss_weight, feat_loss_weight)
        return _update(state, loss, meta)

    return step


def make_tacotron_eval_step(*, device=None):
    """Validation step for Tacotron2: the teacher-forced forward in eval
    (BatchNorm's running statistics, the prenet's masks from a generator
    seeded 0, no other dropout), no optimizer. Returns eval_step(state,
    batch) -> meta: the loss terms and the alignment diagnostics."""
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        b = batch_to_device(batch, dev)
        mel_out, mel_post, gates, aligns = state.model(
            b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"])
        loss, meta = tacotron2_loss(mel_out, mel_post, gates, b["mel_tgt"],
                                    b["gate_tgt"], b["mel_lens"])
        meta["loss"] = loss
        meta.update(alignment_diagnostics(aligns, b["mel_lens"],
                                          b["token_lens"]))
        return meta

    return eval_step
