"""HiFi-GAN vocoder training and fine-tuning CLI (the port's counterpart of
the JAX package's `apps/train_vocoder.py`).

    python -m tts_arabic_torch.apps.train_vocoder --config configs/hifigan_ft.yaml
    python -m tts_arabic_torch.apps.train_vocoder --device cpu --epochs 1

Runs on the CUDA card unless `--device cpu` is given, and raises when there
is none. The published recipe (LSGAN + feature matching + `mel_loss_weight`
x log-mel L1, AdamW(`g_beta1`, `g_beta2`) with weight decay 0.01 behind a
clip of 1000, lr x `lr_decay` each epoch) as one D->G step
(`train.vocoder`), on random `segment_length`-sample crops of the corpus's
wavs in batches of `batch_size`. The generator is HiFi-GAN from
`vocoder_config_path` (V1 when it names no file); the discriminators are
MPD over `mpd_periods` and MSD over `msd_scales` scales, their channels
scaled by `disc_width`. When `vocoder_state_path` names a reference `.pth`,
the generator warm-starts from it (weight norm folded, its optimizer
fresh; the discriminators start from their seeded init, as the reference
publishes none) unless `--from-scratch`. `restore_model` resumes a run.
Per-epoch validation runs on `test_labels` when the config gives usable
ones.

Data parallelism: under `torchrun --nproc-per-node N` the ranks form a
1-D mesh (`parallel.torchrun_mesh`; `--no-mesh` keeps one process's run)
and each step's batch is split over them (`Trainer(mesh=)`).
"""
from __future__ import annotations

import argparse
import dataclasses

from ..data import VocoderSegmentDataset, collate_vocoder
from ..models.convert import fold_weight_norm, load_reference_pth, to_tensors
from ..parallel.mesh import torchrun_mesh
from ..runtime.config import get_config
from ..train.trainer import Trainer
from ..train.vocoder import (init_vocoder_state, make_hifigan_eval_step,
                             make_hifigan_train_step)
from ..vocoder.discriminators import (MultiPeriodDiscriminator,
                                      MultiScaleDiscriminator)
from ..vocoder.hifigan import Generator, HiFiGANConfig


def main(argv=None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/hifigan_ft.yaml")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="stop after this many updates")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--from-scratch", action="store_true",
                        help="skip the vocoder_state_path warm start")
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

    seed = config.get("random_seed", 0) or 0
    segment = config.get("segment_length", 8192)
    batch_size = config.get("batch_size", 16)
    dataset = VocoderSegmentDataset(
        config.train_labels, config.train_wavs_path,
        label_pattern=config.label_pattern, segment_length=segment,
        batch_size=batch_size, seed=seed,
        cache=config.get("cache_dataset", False))

    vc_path = (config.get_path("vocoder_config_path")
               if config.get("vocoder_config_path") else None)
    gen_config = (HiFiGANConfig.from_json(vc_path)
                  if vc_path is not None and vc_path.is_file()
                  else HiFiGANConfig())
    width = config.get("disc_width", 1.0)
    state = init_vocoder_state(
        Generator(gen_config),
        MultiPeriodDiscriminator(
            periods=tuple(config.get("mpd_periods", (2, 3, 5, 7, 11))),
            width=width),
        MultiScaleDiscriminator(n_scales=config.get("msd_scales", 3),
                                width=width),
        g_lr=config.g_lr, g_betas=(config.g_beta1, config.g_beta2),
        d_lr=config.d_lr, d_betas=(config.d_beta1, config.d_beta2),
        seed=seed, device=device)

    vs_path = (config.get_path("vocoder_state_path")
               if config.get("vocoder_state_path") else None)
    if not args.from_scratch and vs_path is not None and vs_path.is_file():
        sd, _ = load_reference_pth(vs_path)
        # in place: the fresh optimizer already holds these parameters
        state.model.load_state_dict(to_tensors(fold_weight_norm(sd)),
                                    strict=True)
        print(f"warm-started generator from {vs_path}")

    trainer = Trainer(
        make_hifigan_train_step(
            device=device, mel_weight=config.get("mel_loss_weight", 45.0),
            lr_decay=config.get("lr_decay", 1.0),
            steps_per_epoch=len(dataset)), state,
        log_dir=config.log_dir, checkpoint_dir=config.checkpoint_dir,
        n_save_states_iter=config.n_save_states_iter,
        n_save_backup_iter=config.n_save_backup_iter, seed=seed,
        net_config=dataclasses.asdict(gen_config), device=device,
        mesh=mesh)
    if config.get("restore_model"):
        trainer.restore(config.get_path("restore_model"))

    val_dataset = eval_fn = None
    if config.get("test_labels"):
        try:
            val_dataset = VocoderSegmentDataset(
                config.test_labels,
                config.get("test_wavs_path") or config.train_wavs_path,
                label_pattern=config.label_pattern, segment_length=segment,
                batch_size=batch_size, seed=1)
            eval_fn = make_hifigan_eval_step(device=device)
        except ValueError:
            val_dataset = None      # no usable held-out wavs
    try:
        trainer.fit(dataset, collate_vocoder,
                    epochs=args.epochs or config.epochs,
                    log_every=args.log_every, val_dataset=val_dataset,
                    eval_fn=eval_fn, max_steps=args.max_steps)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
