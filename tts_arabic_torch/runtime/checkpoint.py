"""Training checkpoints (the port's counterpart of the JAX package's
`runtime/checkpoint.py`): one `torch.save` file holding
{model, optim, step, epoch, config}, as the reference's trainers write it
(`utils/training.py:6-31`), at a states/backup cadence."""
from __future__ import annotations

import os
import pathlib
from typing import Any

import torch


def save_states(path, step: int = 0, epoch: int = 0,
                config: dict | None = None, **state_dicts) -> None:
    """Write a single-file checkpoint; `state_dicts` are named state dicts
    (model=..., optim=...). Written to a temporary file and renamed, so a
    crash mid-write leaves the previous checkpoint intact."""
    payload = dict(state_dicts)
    payload.update(step=int(step), epoch=int(epoch),
                   config=dict(config) if config else None)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_states(path) -> dict[str, Any]:
    """Read a checkpoint back to the CPU: {'step', 'epoch', 'config',
    <names>...}. Tensors, numbers, strings and containers only
    (`weights_only`)."""
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Save cadence of the reference trainers: overwrite `states.ckpt` every
    `n_save_states_iter` steps, keep a versioned backup every
    `n_save_backup_iter` (`configs/nawar_fp.yaml`)."""

    def __init__(self, directory, n_save_states_iter: int = 100,
                 n_save_backup_iter: int = 1000):
        self.directory = pathlib.Path(directory)
        self.n_states = n_save_states_iter
        self.n_backup = n_save_backup_iter

    def maybe_save(self, step: int, epoch: int = 0, config=None,
                   force: bool = False, **state_dicts) -> list:
        """Writes `states.ckpt` when `step` is on the states cadence or
        `force` is set, and `states_<step>.ckpt` on the backup cadence."""
        wrote = []
        if force or step % self.n_states == 0:
            p = self.directory / "states.ckpt"
            save_states(p, step=step, epoch=epoch, config=config,
                        **state_dicts)
            wrote.append(p)
        if step % self.n_backup == 0:
            p = self.directory / f"states_{step}.ckpt"
            save_states(p, step=step, epoch=epoch, config=config,
                        **state_dicts)
            wrote.append(p)
        return wrote

    def latest(self):
        p = self.directory / "states.ckpt"
        return p if p.exists() else None
