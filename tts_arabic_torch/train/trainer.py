"""Training loop (the port's counterpart of the JAX package's
`train/trainer.py`, reference `scripts/train_{fp,fp_adv,tc2,tc2_adv}.py`):
per-epoch shuffle of the batches, the train step, scalar logging (JSONL,
and TensorBoard where it imports), checkpoints at the states/backup
cadence of the config, and per-epoch validation with `val/` scalars and
the first sample's figures.

A checkpoint holds the JAX trainer's keys: `model` and `optim`; with a
critic also `model_d` and `optim_d`, and `spectral_d` where it keeps
power-iteration vectors (the mel critic; HiFi-GAN's discriminators keep
none); for a model with BatchNorm also `batch_stats` (its running
statistics, which `model` holds too, in the reference layout).

Steps are counted in updates taken: the checkpoint after the n-th update
says step n, and a restored run goes on from there. Log lines are labelled
with the 0-based index of the step, as the JAX trainer labels them.

With a mesh (data parallelism over `torch.distributed`, one process a
rank): the model, the critic and its vectors are replicated from rank 0;
every rank shuffles with the same seed, collates the same global batch and
steps on its own rows (`parallel.data_parallel_jit`), so the state stays
the same on every rank; only rank 0 logs, validates and writes
checkpoints, and a restore reads the checkpoint on rank 0 and broadcasts
it.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import data_parallel_jit, replicate
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
                 net_config: Optional[dict] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.is_main = mesh is None or mesh.rank == 0
        self.step_fn = step_fn
        if mesh is not None:
            self.step_fn = data_parallel_jit(step_fn, mesh)
            state.mesh = mesh
            replicate([state.model, state.critic or [],
                       state.spectral or {}], mesh)
        self.state = state
        self.seed = seed
        self.logger = MetricLogger(log_dir) if self.is_main else None
        self.ckpt = CheckpointManager(checkpoint_dir, n_save_states_iter,
                                      n_save_backup_iter)
        self.net_config = net_config or {}

    def restore(self, path=None) -> int:
        """Load model, optimizer and step from `path` (default: the latest
        `states.ckpt`); returns the step, 0 when there is nothing."""
        path = path or self.ckpt.latest()
        if self.mesh is not None:   # rank 0's view of the checkpoint
            box = [path]
            dist.broadcast_object_list(box, self._src(),
                                       group=self.mesh.group(None))
            path = box[0]
        if path is None:
            return 0
        if self.mesh is None:
            st = load_states(path)
        else:
            box = [load_states(path) if self.is_main else None]
            dist.broadcast_object_list(box, self._src(),
                                       group=self.mesh.group(None))
            st = box[0]
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

    def _src(self) -> int:
        return int(self.mesh.devices.reshape(-1)[0])

    def save(self, epoch: int, force: bool = False) -> list:
        """The checkpoint at this step when the cadence (or `force`) says
        so; on a mesh only rank 0 writes. Returns the paths written."""
        if not self.is_main:
            return []
        state = self.state
        trees = {"model": state.model.state_dict(),
                 "optim": state.optimizer.state_dict()}
        if state.critic is not None:
            trees.update(model_d=state.critic.state_dict(),
                         optim_d=state.d_optimizer.state_dict())
        if state.spectral is not None:
            trees["spectral_d"] = dict(state.spectral)
        stats = batch_stats(state.model)
        if stats:
            trees["batch_stats"] = stats
        return self.ckpt.maybe_save(
            state.step, epoch=epoch, force=force,
            config={"net_config": self.net_config}, **trees)

    def validate(self, val_dataset, collate_fn, eval_fn, step: int,
                 figures: bool = True) -> dict:
        """Mean `val/` scalars over a validation set, each batch weighted by
        its size, and with `figures` the first sample's alignment and mels
        (`MetricLogger.log_alignment_and_mels`; reference `validate()`,
        train.py:19-58). `eval_fn(state, batch) -> (meta, artifacts)`, see
        `make_fastpitch_eval_step`; artifacts None (the vocoder's) draw
        nothing. Figures need matplotlib. On a mesh only rank 0 validates
        (the whole batches, with no collective); the others return {}."""
        if not self.is_main:
            return {}
        sums, n = {}, 0
        first_artifacts = None
        for b_idx in range(len(val_dataset)):
            batch = collate_fn(val_dataset[b_idx])
            b = int(next(iter(batch.values())).shape[0])
            meta, artifacts = eval_fn(self.state, batch)
            if figures and first_artifacts is None and artifacts is not None:
                first_artifacts = {k: v[0].float().cpu().numpy()
                                   for k, v in artifacts.items()}
            for k, v in meta.items():
                sums[k] = sums.get(k, 0.0) + float(v) * b
            n += b
        means = {k: v / max(n, 1) for k, v in sums.items()}
        self.logger.log_scalars(step, means, prefix="val/")
        if first_artifacts is not None:
            a = first_artifacts
            self.logger.log_alignment_and_mels(
                step, alignment=a["alignment"].T, mel_pred=a["mel_pred"].T,
                mel_target=a["mel_tgt"].T)
        print(f"validation @ step {step}: "
              f"loss {means.get('loss', float('nan')):.4f} "
              f"({len(val_dataset)} batches)", flush=True)
        return means

    def fit(self, dataset, collate_fn, epochs: int, start_epoch: int = 0,
            log_every: int = 10, on_epoch_end: Optional[Callable] = None,
            val_dataset=None, val_collate_fn=None, eval_fn=None,
            max_steps: Optional[int] = None,
            figures: bool = True) -> TrainState:
        """`dataset` yields whole batches (`DynBatchDataset`). Runs epochs
        `start_epoch` .. `epochs` - 1 and stops early once `max_steps`
        updates are taken. After each epoch (a cut one included) it
        validates, its batches collated by `val_collate_fn` (default
        `collate_fn`) and with `figures` passed on to `validate`, then
        calls `on_epoch_end(trainer, epoch)`. Ends with a checkpoint of the
        last state."""
        epoch, wrote = start_epoch, []
        for epoch in range(start_epoch, epochs):
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
                if index % log_every == 0 and self.is_main:
                    meta_host = {k: float(v) for k, v in meta.items()}
                    meta_host["step_time"] = time.perf_counter() - t0
                    self.logger.log_scalars(index, meta_host,
                                            prefix="train/")
                    print(f"epoch {epoch} step {index} "
                          f"loss {meta_host['loss']:.4f}", flush=True)
                wrote = self.save(epoch)
            if val_dataset is not None and eval_fn is not None:
                self.validate(val_dataset, val_collate_fn or collate_fn,
                              eval_fn, self.state.step, figures=figures)
            if on_epoch_end is not None:
                on_epoch_end(self, epoch)
        if not wrote:   # the last state is not on disk yet
            self.save(epoch, force=True)
        return self.state

    def close(self) -> None:
        if self.logger is not None:
            self.logger.close()
