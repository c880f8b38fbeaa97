"""Training observability (the port's counterpart of the JAX package's
`runtime/logging.py`; reference `TBLogger`, utils/logging.py:5-40):
loss scalars, the gradient norm, the learning rate, parameter histograms
and the validation figures (alignment, mels). Scalars go to
`metrics.jsonl` in the log directory, one JSON object per call, and to
TensorBoard where its writer imports; histograms only to TensorBoard;
figures to TensorBoard, or to a PNG in the log directory without it.
Figures need matplotlib, imported at the first one."""
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

    def log_training(self, step: int, meta: Mapping[str, float],
                     grad_norm: float | None = None,
                     lr: float | None = None) -> dict:
        """A training step's scalars, the gradient norm and the learning
        rate, under `train/`."""
        scalars = dict(meta)
        if grad_norm is not None:
            scalars["grad_norm"] = grad_norm
        if lr is not None:
            scalars["lr"] = lr
        return self.log_scalars(step, scalars, prefix="train/")

    def log_histograms(self, step: int, module,
                       prefix: str = "params/") -> None:
        """One TensorBoard histogram per parameter of `module` (its
        `named_parameters`, the name's dots as slashes); nothing without
        TensorBoard."""
        if not self._tb:
            return
        for name, p in module.named_parameters():
            self._tb.add_histogram(prefix + name.replace(".", "/"),
                                   p.detach().float().cpu().numpy(), step)

    def log_figure(self, step: int, tag: str, fig) -> None:
        """A matplotlib figure to TensorBoard, or to `<tag>_<step>.png`
        (slashes as underscores) in the log directory without it."""
        if self._tb:
            self._tb.add_figure(tag, fig, step)
        else:
            fig.savefig(self.log_dir / f"{tag.replace('/', '_')}_{step}.png")

    def log_alignment_and_mels(self, step: int, alignment=None, mel_pred=None,
                               mel_post=None, mel_target=None) -> None:
        """The validation figures (reference utils/logging.py:23-40):
        `val/alignment` [T_mel, T_txt] and `val/mels`, the predicted,
        postnet and target mels [n_mels, T] side by side."""
        from ..eval.plotting import plot_alignment, plot_mel_triptych
        if alignment is not None:
            self.log_figure(step, "val/alignment", plot_alignment(alignment))
        if mel_target is not None or mel_pred is not None:
            self.log_figure(step, "val/mels",
                            plot_mel_triptych(mel_pred, mel_post, mel_target))

    def close(self) -> None:
        if self._tb:
            self._tb.close()
        self._jsonl.close()
