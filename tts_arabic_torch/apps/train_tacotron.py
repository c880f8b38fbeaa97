"""Tacotron2 training CLI (reference `scripts/train_tc2.py` and
`scripts/train_tc2_adv.py`).

    python -m tts_arabic_torch.apps.train_tacotron --config configs/nawar_tc2.yaml
    python -m tts_arabic_torch.apps.train_tacotron --config configs/nawar_tc2_adv.yaml --adv
    python -m tts_arabic_torch.apps.train_tacotron --device cpu --max-steps 2

Runs on the CUDA card unless `--device cpu` is given, and raises when there
is none. The full-width Tacotron2 (`Tacotron2Config()` with the config's
`decoder_max_step`) is trained from seeded random weights, or from
`restore_model` when the config names one, in batches of `batch_size`;
a batch whose longest mel is over `max_frames` frames is cut to its first
`truncated_batch_size` samples (train_tc2.py:100-113). `balanced_sampling`
draws each epoch's order from `sampler_weights_file`. The gradients are
clipped at `grad_clip_thresh`. `--adv` adds the critic, as
`train_fastpitch --adv` does, reading the postnet mel. Per-epoch
validation runs on `test_labels` when the config gives them.

Data parallelism: under `torchrun --nproc-per-node N` the ranks form a
1-D mesh (`parallel.torchrun_mesh`; `--no-mesh` keeps one process's run)
and each batch is split over them (`Trainer(mesh=)`), BatchNorm's
statistics taken over the whole batch. A batch (a truncated one too) must
divide by N.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ..data import ArabDataset, WeightedSampler, collate_tacotron
from ..models.tacotron2 import Tacotron2, Tacotron2Config, init_tacotron2
from ..parallel.mesh import torchrun_mesh
from ..runtime.config import get_config
from ..train.steps import (TrainState, add_critic, make_optimizer,
                           make_tacotron_eval_step, make_tacotron_train_step)
from ..train.trainer import Trainer


class _BatchedView:
    """Fixed-size batches over an ArabDataset with per-epoch shuffling (or
    the sampler's order) and the reference's long-batch truncation."""

    def __init__(self, ds, batch_size, max_frames=2000, truncated=6, seed=0,
                 sampler=None):
        self.ds = ds
        self.bs = batch_size
        self.max_frames = max_frames
        self.truncated = truncated
        self.rng = np.random.default_rng(seed)
        self.sampler = sampler  # balanced sampling (reference train.py:150)
        self.order = np.arange(len(ds))
        self.shuffle()

    def shuffle(self):
        if self.sampler is not None:
            self.order = self.sampler.sample()
        else:
            self.rng.shuffle(self.order)

    def __len__(self):
        return (len(self.ds) + self.bs - 1) // self.bs

    def __getitem__(self, i):
        ids = self.order[i * self.bs: (i + 1) * self.bs]
        items = [self.ds[j] for j in ids]
        longest = max(m.shape[1] for _, m in items)
        if longest > self.max_frames:
            items = items[: self.truncated]
        return items


def _batches(config, ds, sampler=None) -> _BatchedView:
    return _BatchedView(ds, config.batch_size,
                        max_frames=config.get("max_frames", 2000),
                        truncated=config.get("truncated_batch_size", 6),
                        sampler=sampler)


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/nawar_tc2.yaml")
    parser.add_argument("--adv", action="store_true",
                        help="adversarial training (PatchDiscriminator)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many updates")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--no-figures", action="store_true",
                        help="validate without the alignment and mel "
                             "figures (they need matplotlib)")
    parser.add_argument("--device", default=None,
                        help="cuda (default), cpu, or cuda:<i>; under "
                             "torchrun cuda:$LOCAL_RANK by default")
    parser.add_argument("--no-mesh", action="store_true",
                        help="one process even under torchrun")
    parser.add_argument("--dist-backend", default=None,
                        help="torch.distributed backend under torchrun: "
                             "nccl (default on cards) or gloo (default on "
                             "the CPU; several ranks on one card)")
    args = parser.parse_args(argv)
    mesh, device = torchrun_mesh(args.device, args.dist_backend,
                                 not args.no_mesh)
    config = get_config(args.config)

    dataset = ArabDataset(config.train_labels, config.train_wavs_path,
                          label_pattern=config.label_pattern,
                          cache=config.get("cache_dataset", False))
    sampler = None
    if config.get("balanced_sampling"):
        sampler = WeightedSampler.from_file(
            config.get_path("sampler_weights_file"))
    batches = _batches(config, dataset, sampler)

    seed = config.get("random_seed", 0) or 0
    model_config = Tacotron2Config(
        decoder_max_step=config.get("decoder_max_step", 2000))
    model = init_tacotron2(Tacotron2(model_config), seed).to(device)
    wd = config.get("weight_decay", 1e-6)
    state = TrainState(model, make_optimizer(
        model, config.g_lr, config.g_beta1, config.g_beta2, wd,
        grad_clip=config.get("grad_clip_thresh", 1.0)))
    if args.adv:
        add_critic(state, config, seed + 1, device)
    trainer = Trainer(
        make_tacotron_train_step(
            device=device,
            gan_loss_weight=config.get("gan_loss_weight", 4.0),
            feat_loss_weight=config.get("feat_loss_weight", 1.0)), state,
        log_dir=config.log_dir, checkpoint_dir=config.checkpoint_dir,
        n_save_states_iter=config.n_save_states_iter,
        n_save_backup_iter=config.n_save_backup_iter, seed=seed,
        net_config=dataclasses.asdict(model_config), device=device,
        mesh=mesh)
    if config.get("restore_model"):
        trainer.restore(config.get_path("restore_model"))

    val_batches = eval_fn = None
    if config.get("test_labels"):
        val_dataset = ArabDataset(
            config.test_labels,
            config.get("test_wavs_path") or config.train_wavs_path,
            label_pattern=config.label_pattern)
        if len(val_dataset):
            val_batches = _batches(config, val_dataset)
            eval_fn = make_tacotron_eval_step(device=device)
    try:
        trainer.fit(batches, collate_tacotron,
                    epochs=args.epochs or config.epochs,
                    log_every=args.log_every, val_dataset=val_batches,
                    eval_fn=eval_fn, max_steps=args.max_steps,
                    figures=not args.no_figures)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
