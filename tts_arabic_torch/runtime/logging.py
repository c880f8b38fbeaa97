"""Training scalars (the port's counterpart of the JAX package's
`runtime/logging.py`): always to `metrics.jsonl` in the log directory, one
JSON object per call, and to TensorBoard where its writer imports. Figures
(alignments, mels) are not drawn: they need matplotlib, which the port does
not depend on."""
from __future__ import annotations

import json
import pathlib
import time
from typing import Mapping


def _tb_writer(log_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class MetricLogger:
    def __init__(self, log_dir):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._tb = _tb_writer(str(self.log_dir))
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, scalars: Mapping[str, float],
                    prefix: str = "") -> dict:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}"
            rec[name] = float(v)
            if self._tb:
                self._tb.add_scalar(name, rec[name], step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        return rec

    def close(self) -> None:
        if self._tb:
            self._tb.close()
        self._jsonl.close()
