"""FastPitch training CLI (reference `scripts/train_fp.py` and
`scripts/train_fp_adv.py`).

    python -m tts_arabic_torch.apps.train_fastpitch --config configs/nawar_fp.yaml
    python -m tts_arabic_torch.apps.train_fastpitch --config configs/nawar_fp_adv.yaml --adv
    python -m tts_arabic_torch.apps.train_fastpitch --device cpu --max-steps 2

Runs on the CUDA card unless `--device cpu` is given, and raises when there
is none. The full-width FastPitch (`FastPitchConfig()`) is trained from
seeded random weights, or from `restore_model` when the config names one.
`--adv` adds the critic (`PatchDiscriminator(32)`, its AdamW from the
config's `d_lr`/`d_beta1`/`d_beta2`, the loss weights `gan_loss_weight`
and `feat_loss_weight`). Per-epoch validation runs on `test_labels` when
the config gives them.

Data parallelism: under `torchrun --nproc-per-node N` the ranks form a
1-D mesh (`parallel.torchrun_mesh`; `--no-mesh` keeps one process's run)
and each step's batch is split over them (`Trainer(mesh=)`):

    torchrun --nproc-per-node 4 -m tts_arabic_torch.apps.train_fastpitch --config configs/nawar_fp.yaml
"""
from __future__ import annotations

import argparse

from ..data import ArabDatasetFastPitch, DynBatchDataset, collate_fastpitch
from ..models.fastpitch import FastPitch, FastPitchConfig
from ..models.layers import init_weights
from ..parallel.mesh import torchrun_mesh
from ..runtime.config import get_config
from ..train.steps import (TrainState, add_critic, make_fastpitch_eval_step,
                           make_fastpitch_train_step, make_optimizer)
from ..train.trainer import Trainer


def _dataset(config, labels, wavs, f0_path, cache):
    return ArabDatasetFastPitch(
        labels, wavs, label_pattern=config.label_pattern,
        f0_dict_path=f0_path, f0_mean=config.f0_mean, f0_std=config.f0_std,
        cache=cache)


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/nawar_fp.yaml")
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

    f0_path = (config.get_path("f0_dict_path")
               if config.get("f0_dict_path") else None)
    if f0_path is not None and not f0_path.is_file():
        f0_path = None
    dataset = _dataset(config, config.train_labels, config.train_wavs_path,
                       f0_path, config.get("cache_dataset", False))
    dyn = DynBatchDataset(dataset, max_lengths=config.max_lengths,
                          batch_sizes=config.batch_sizes)

    seed = config.get("random_seed", 0) or 0
    model_config = FastPitchConfig()
    model = init_weights(FastPitch(model_config), seed)
    # corpus pitch statistics in the weights (reference model.py:213-214)
    model.pitch_mean.fill_(config.f0_mean)
    model.pitch_std.fill_(config.f0_std)
    model.to(device)
    wd = config.get("weight_decay", 1e-6)
    state = TrainState(model, make_optimizer(
        model, config.g_lr, config.g_beta1, config.g_beta2, wd))
    if args.adv:
        add_critic(state, config, seed + 1, device)
    trainer = Trainer(
        make_fastpitch_train_step(
            device=device,
            gan_loss_weight=config.get("gan_loss_weight", 3.0),
            feat_loss_weight=config.get("feat_loss_weight", 1.0)), state,
        log_dir=config.log_dir, checkpoint_dir=config.checkpoint_dir,
        n_save_states_iter=config.n_save_states_iter,
        n_save_backup_iter=config.n_save_backup_iter,
        seed=seed, net_config=model_config.to_reference_net_config(),
        device=device, mesh=mesh)
    if config.get("restore_model"):
        trainer.restore(config.get_path("restore_model"))

    val_dyn = eval_fn = None
    if config.get("test_labels"):
        val_dataset = _dataset(
            config, config.test_labels,
            config.get("test_wavs_path") or config.train_wavs_path, f0_path,
            False)
        if len(val_dataset):
            val_dyn = DynBatchDataset(val_dataset,
                                      max_lengths=config.max_lengths,
                                      batch_sizes=config.batch_sizes)
            eval_fn = make_fastpitch_eval_step(device=device)
    try:
        trainer.fit(dyn, collate_fastpitch,
                    epochs=args.epochs or config.epochs,
                    log_every=args.log_every, val_dataset=val_dyn,
                    eval_fn=eval_fn, max_steps=args.max_steps,
                    figures=not args.no_figures)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
