"""FastPitch train and eval steps, MSE recipe (the port's counterpart of
the JAX package's `train/steps.py`; the adversarial critic is not ported).

One step: soft ConvAttention -> MAS on the card (`align.mas_durations`,
the CUDA kernel of `ops/mas.py` for CUDA tensors) -> teacher-forced
forward with the hard durations -> composite loss + binarization KL ->
backward -> global-norm clip at 1000 -> AdamW. Float32 throughout, as the
JAX step is. The dropout masks come from a generator on the device seeded
by (seed, step), so a step can be replayed exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..align.mas import mas_durations
from ..eval.alignment import alignment_diagnostics
from ..models.fastpitch import FastPitch
from ..runtime.device import resolve_device
from .losses import attention_binarization_loss, fastpitch_loss

GRAD_CLIP = 1000.0      # global-norm clip of the reference recipe


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer and the count of updates
    taken. The step functions update all three in place."""
    model: FastPitch
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(model: torch.nn.Module, lr=1e-4, beta1=0.9, beta2=0.999,
                   weight_decay=1e-6) -> torch.optim.AdamW:
    """AdamW over the model's parameters (reference recipe; the clip is in
    the step). Decoupled decay, eps 1e-8, as optax's `adamw`. The corpus
    pitch statistics are buffers here, so they are not decayed; the JAX
    package holds them as parameters and decays them by lr * wd per step."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(beta1, beta2),
                             eps=1e-8, weight_decay=weight_decay)


def batch_to_device(batch: dict, device) -> dict:
    """Collated numpy arrays -> tensors on `device` (integers as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if not t.is_floating_point():
            t = t.to(torch.long)
        out[k] = t.to(device, non_blocking=True)
    return out


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout generator, seeded by (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 32) + int(step))
    return gen


def _forward(model, b, durs, gen):
    return model.forward_train(
        b["tokens"], b["token_lens"], b["mel_tgt"], b["mel_lens"],
        b["pitch_dense"], b["energy_dense"], b["attn_prior"], durs, gen=gen)


def make_fastpitch_train_step(*, device=None):
    """Returns step(state, batch, seed) -> meta, `batch` from
    `data.collate_fastpitch` (numpy or tensors). It updates `state` in
    place and returns the loss terms and the pre-clip gradient norm as
    0-d tensors. `device=None` means the CUDA card, which must exist."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict, seed: int = 0) -> dict:
        model, opt = state.model, state.optimizer
        b = batch_to_device(batch, dev)
        gen = dropout_generator(seed, state.step, dev)
        with torch.no_grad():
            attn_soft, _ = model.align_attention(b["tokens"], b["mel_tgt"],
                                                 b["attn_prior"])
        attn_hard, durs = mas_durations(attn_soft, b["token_lens"],
                                        b["mel_lens"])
        del attn_soft

        out = _forward(model, b, durs, gen)
        loss, meta = fastpitch_loss(out, b)
        kl = attention_binarization_loss(attn_hard, out["attn_soft"])
        loss = loss + kl
        meta["kl_loss"] = kl
        meta["loss"] = loss

        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        meta["grad_norm"] = torch.nn.utils.clip_grad_norm_(params, GRAD_CLIP)
        opt.step()
        state.step += 1
        return {k: v.detach() for k, v in meta.items()}

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
        out = _forward(model, b, durs, None)
        loss, meta = fastpitch_loss(out, b)
        kl = attention_binarization_loss(attn_hard, out["attn_soft"])
        meta["kl_loss"] = kl
        meta["loss"] = loss + kl
        meta.update(alignment_diagnostics(out["attn_soft"], b["mel_lens"],
                                          b["token_lens"]))
        return meta

    return eval_step
