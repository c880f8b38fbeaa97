"""Training loop (the port's counterpart of the JAX package's
`train/trainer.py`, reference `scripts/train_{fp,fp_adv,tc2,tc2_adv}.py`):
per-epoch shuffle of the batches, the train step, scalar logging (JSONL,
and TensorBoard where it imports), checkpoints at the states/backup
cadence of the config, and per-epoch validation with `val/` scalars.

A checkpoint holds the JAX trainer's keys: `model` and `optim`; with a
critic also `model_d`, `optim_d` and `spectral_d` (its power-iteration
vectors); for a model with BatchNorm also `batch_stats` (its running
statistics, which `model` holds too, in the reference layout).

Steps are counted in updates taken: the checkpoint after the n-th update
says step n, and a restored run goes on from there. Log lines are labelled
with the 0-based index of the step, as the JAX trainer labels them.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..runtime.checkpoint import CheckpointManager, load_states
from ..runtime.device import resolve_device
from ..runtime.logging import MetricLogger
from .steps import TrainState


_BATCH_NORMS = (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)


def batch_stats(model: torch.nn.Module) -> dict:
    """The running statistics of the model's BatchNorm layers, under their
    state-dict names ({} when it has none)."""
    return {f"{name}.{k}": v for name, mod in model.named_modules()
            if isinstance(mod, _BATCH_NORMS)
            for k, v in mod.named_buffers(recurse=False)}


class Trainer:
    def __init__(self, step_fn: Callable, state: TrainState, *, log_dir,
                 checkpoint_dir, n_save_states_iter: int = 100,
                 n_save_backup_iter: int = 1000, seed: int = 0,
                 net_config: Optional[dict] = None, device=None):
        self.device = resolve_device(device)
        self.step_fn = step_fn
        self.state = state
        self.seed = seed
        self.logger = MetricLogger(log_dir)
        self.ckpt = CheckpointManager(checkpoint_dir, n_save_states_iter,
                                      n_save_backup_iter)
        self.net_config = net_config or {}

    def restore(self, path=None) -> int:
        """Load model, optimizer and step from `path` (default: the latest
        `states.ckpt`); returns the step, 0 when there is nothing."""
        path = path or self.ckpt.latest()
        if path is None:
            return 0
        st = load_states(path)
        state = self.state
        state.model.load_state_dict(st["model"])
        if st.get("batch_stats") is not None:
            state.model.load_state_dict(st["batch_stats"], strict=False)
        if "optim" in st:
            state.optimizer.load_state_dict(st["optim"])
        if state.critic is not None and st.get("model_d") is not None:
            state.critic.load_state_dict(st["model_d"])
            if "optim_d" in st:
                state.d_optimizer.load_state_dict(st["optim_d"])
            if st.get("spectral_d") is not None:
                dev = next(state.critic.parameters()).device
                state.spectral = {k: v.to(dev)
                                  for k, v in st["spectral_d"].items()}
        state.step = int(st["step"])
        return state.step

    def save(self, epoch: int, force: bool = False) -> list:
        state = self.state
        trees = {"model": state.model.state_dict(),
                 "optim": state.optimizer.state_dict()}
        if state.critic is not None:
            trees.update(model_d=state.critic.state_dict(),
                         optim_d=state.d_optimizer.state_dict(),
                         spectral_d=dict(state.spectral))
        stats = batch_stats(state.model)
        if stats:
            trees["batch_stats"] = stats
        return self.ckpt.maybe_save(
            state.step, epoch=epoch, force=force,
            config={"net_config": self.net_config}, **trees)

    def validate(self, val_dataset, collate_fn, eval_fn, step: int) -> dict:
        """Mean `val/` scalars over a validation set, each batch weighted by
        its size (reference `validate()`, train.py:19-58). `eval_fn(state,
        batch) -> meta`, see `make_fastpitch_eval_step`."""
        sums, n = {}, 0
        for b_idx in range(len(val_dataset)):
            batch = collate_fn(val_dataset[b_idx])
            b = int(next(iter(batch.values())).shape[0])
            meta = eval_fn(self.state, batch)
            for k, v in meta.items():
                sums[k] = sums.get(k, 0.0) + float(v) * b
            n += b
        means = {k: v / max(n, 1) for k, v in sums.items()}
        self.logger.log_scalars(step, means, prefix="val/")
        print(f"validation @ step {step}: "
              f"loss {means.get('loss', float('nan')):.4f} "
              f"({len(val_dataset)} batches)", flush=True)
        return means

    def fit(self, dataset, collate_fn, epochs: int, log_every: int = 10,
            val_dataset=None, eval_fn=None,
            max_steps: Optional[int] = None) -> TrainState:
        """`dataset` yields whole batches (`DynBatchDataset`). Stops after
        `epochs` epochs or once `max_steps` updates are taken, validates
        after each epoch (a cut one included) and ends with a checkpoint of
        the last state."""
        epoch, wrote = 0, []
        for epoch in range(epochs):
            if max_steps is not None and self.state.step >= max_steps:
                break
            if hasattr(dataset, "shuffle"):
                dataset.shuffle()
            for b_idx in range(len(dataset)):
                if max_steps is not None and self.state.step >= max_steps:
                    break
                batch = collate_fn(dataset[b_idx])
                index = self.state.step
                t0 = time.perf_counter()
                meta = self.step_fn(self.state, batch, self.seed)
                if index % log_every == 0:
                    meta_host = {k: float(v) for k, v in meta.items()}
                    meta_host["step_time"] = time.perf_counter() - t0
                    self.logger.log_scalars(index, meta_host,
                                            prefix="train/")
                    print(f"epoch {epoch} step {index} "
                          f"loss {meta_host['loss']:.4f}", flush=True)
                wrote = self.save(epoch)
            if val_dataset is not None and eval_fn is not None:
                self.validate(val_dataset, collate_fn, eval_fn,
                              self.state.step)
        if not wrote:   # the last state is not on disk yet
            self.save(epoch, force=True)
        return self.state

    def close(self) -> None:
        self.logger.close()
