"""HiFi-GAN vocoder training (the port's counterpart of the JAX package's
`train/vocoder.py`): the published recipe as one D->G step.

The generator runs on log-mels of the waveform batch computed on the
device (`audio.mel.log_mel_spectrogram`: a segment of S samples gives S/hop
frames, so the generated waveform aligns sample for sample with the
target). The discriminators' update comes first and reads the generator's
output from a no-grad forward with the parameters before the update; the
generator's loss then asks the UPDATED discriminators: LSGAN adversarial +
feature matching (x2 inside `feature_loss`) + 45 x L1 between log-mels.
Both optimizers are AdamW behind a global-norm clip of 1000 with weight
decay 0.01 (JAX `apps/train_vocoder.py:69-81`), one for the generator and
one over both discriminators.

The generator's MRF ResBlocks run the ResBlock1 kernel on the card: the
no-grad forward launches it directly, the generator's forward through
`ResBlock1Function` (its backward recomputes the block in plain PyTorch).
The state is `steps.TrainState` with `model` = the `Generator`, `critic` =
`nn.ModuleDict(mpd=..., msd=...)` and `spectral` None, so
`train.trainer.Trainer` checkpoints it under JAX's keys (`model`, `optim`,
`model_d`, `optim_d`).

Data parallelism (`TrainState.mesh`): every term is a mean over its
tensor's elements, and every rank holds the same number of crops of the
same length, so the global batch's loss is the mean of the ranks' losses:
each rank back-propagates its loss over the data axis's size and the
gradients are summed before the clips (`ClippedAdamW.clip_and_step`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..audio.mel import MelConfig, log_mel_spectrogram
from ..models.layers import init_weights
from ..runtime.device import resolve_device
from ..vocoder.discriminators import (discriminator_loss, feature_loss,
                                      generator_loss)
from ..parallel.mesh import DATA_AXIS
from .steps import (TrainState, _frozen, _reduce_meta, batch_to_device,
                    make_optimizer)

WEIGHT_DECAY = 0.01     # the JAX CLI's adamw(..., weight_decay=0.01)


def init_vocoder_state(gen: nn.Module, mpd: nn.Module, msd: nn.Module, *,
                       g_lr: float = 2e-4, g_betas=(0.8, 0.99),
                       d_lr: float = 2e-4, d_betas=(0.8, 0.99),
                       seed: int = 0, device=None) -> TrainState:
    """Seeded random init of the generator (seed) and the discriminators
    (seed + 1, seed + 2; `models.layers.init_weights`) on `device`, with
    fresh optimizers: optax's `chain(clip_by_global_norm(1000),
    adamw(lr, b1, b2, weight_decay=0.01))`."""
    dev = resolve_device(device)
    gen = init_weights(gen, seed).to(dev)
    critic = nn.ModuleDict({"mpd": init_weights(mpd, seed + 1),
                            "msd": init_weights(msd, seed + 2)}).to(dev)
    return TrainState(
        gen, make_optimizer(gen, g_lr, *g_betas, weight_decay=WEIGHT_DECAY),
        critic=critic, d_optimizer=make_optimizer(
            critic, d_lr, *d_betas, weight_decay=WEIGHT_DECAY))


def staircase_lr(optimizer: torch.optim.Optimizer, n_updates: int,
                 decay: float, steps_per_epoch: int) -> None:
    """optax's `exponential_decay(base, steps_per_epoch, decay,
    staircase=True)` at the count of updates taken before this one: each
    group's lr = its base lr x decay^(n_updates // steps_per_epoch). The
    base is kept in the group (`initial_lr`), so it comes back with a
    restored optimizer."""
    for group in optimizer.param_groups:
        base = group.setdefault("initial_lr", group["lr"])
        group["lr"] = base * decay ** (n_updates // steps_per_epoch)


def _logmel(wave: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, S] waveform -> [B, S/hop, n_mels] log-mel (generator layout)."""
    return log_mel_spectrogram(wave, cfg).transpose(1, 2)


def make_hifigan_train_step(*, device=None, mel_weight: float = 45.0,
                            lr_decay: float = 1.0, steps_per_epoch: int = 1,
                            mel_cfg: Optional[MelConfig] = None):
    """Returns step(state, batch, seed=0) -> meta, `batch` from
    `data.collate_vocoder` ({"wave": [B, S]} in [-1, 1]). It updates
    `state` in place and returns JAX's terms as 0-d tensors: loss, loss_d,
    d_mpd_loss, d_msd_loss, mel_loss, gen_adv_loss, feat_loss. The seed is
    not read: the recipe has no random layer. `device=None` means the CUDA
    card, which must exist."""
    dev = resolve_device(device)
    cfg = mel_cfg or MelConfig()

    def step(state: TrainState, batch: dict, seed: int = 0) -> dict:
        del seed
        gen, critic = state.model, state.critic
        share = 1.0 if state.mesh is None else 1.0 / state.mesh.axis_size(
            DATA_AXIS)
        wave = batch_to_device(batch, dev)["wave"]
        mel_in = _logmel(wave, cfg)
        with torch.no_grad():
            y_hat_ng = gen(mel_in)

        s_r, s_g, _, _ = critic["mpd"](wave, y_hat_ng)
        ld_f, _, _ = discriminator_loss(s_r, s_g)
        s_r, s_g, _, _ = critic["msd"](wave, y_hat_ng)
        ld_s, _, _ = discriminator_loss(s_r, s_g)
        loss_d = ld_f + ld_s
        staircase_lr(state.d_optimizer, state.step, lr_decay,
                     steps_per_epoch)
        state.d_optimizer.zero_grad(set_to_none=True)
        (loss_d * share if share != 1.0 else loss_d).backward()
        state.d_optimizer.clip_and_step(state.mesh)
        del y_hat_ng, s_r, s_g

        y_hat = gen(mel_in)
        l_mel = torch.mean(torch.abs(_logmel(y_hat, cfg) - mel_in))
        with _frozen(critic):
            _, s_g, f_r, f_g = critic["mpd"](wave, y_hat)
            adv_f, _ = generator_loss(s_g)
            fm_f = feature_loss(f_r, f_g)
            _, s_g, f_r, f_g = critic["msd"](wave, y_hat)
            adv_s, _ = generator_loss(s_g)
            fm_s = feature_loss(f_r, f_g)
        loss = adv_f + adv_s + fm_f + fm_s + mel_weight * l_mel
        staircase_lr(state.optimizer, state.step, lr_decay, steps_per_epoch)
        state.optimizer.zero_grad(set_to_none=True)
        (loss * share if share != 1.0 else loss).backward()
        state.optimizer.clip_and_step(state.mesh)
        state.step += 1
        meta = dict(loss=loss, loss_d=loss_d, d_mpd_loss=ld_f,
                    d_msd_loss=ld_s, mel_loss=l_mel,
                    gen_adv_loss=adv_f + adv_s, feat_loss=fm_f + fm_s)
        return _reduce_meta({k: v.detach() for k, v in meta.items()},
                            state.mesh, mean=True)

    return step


def make_hifigan_eval_step(*, device=None,
                           mel_cfg: Optional[MelConfig] = None):
    """Validation: the log-mel L1 of the resynthesized waveform (upstream's
    validation metric). Returns eval_step(state, batch) -> (meta, None),
    no figures, as the JAX step."""
    dev = resolve_device(device)
    cfg = mel_cfg or MelConfig()

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        mel_in = _logmel(batch_to_device(batch, dev)["wave"], cfg)
        y_hat = state.model(mel_in)
        l_mel = torch.mean(torch.abs(_logmel(y_hat, cfg) - mel_in))
        return {"loss": l_mel, "mel_loss": l_mel}, None

    return eval_step
