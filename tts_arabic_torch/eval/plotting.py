"""Matplotlib figures for training and evaluation (the port's copy of the
JAX package's `eval/plotting.py`; reference `utils/plotting.py:6-40`).
matplotlib is imported at the first figure, so the module imports where
it is not installed."""
from __future__ import annotations

import numpy as np


def _fig(ncols=1, figsize=(10, 4)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt.subplots(1, ncols, figsize=figsize)


def plot_alignment(alignment, title="alignment"):
    """alignment: [T_mel, T_txt] (or transposed)."""
    fig, ax = _fig()
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    ax.set_xlabel("decoder step")
    ax.set_ylabel("text position")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def plot_mel(mel, title="mel"):
    """mel: [n_mels, T]."""
    fig, ax = _fig()
    im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower",
                   interpolation="none")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def plot_mel_triptych(mel_pred=None, mel_post=None, mel_target=None):
    """Side-by-side predicted / postnet / target mels (reference's 3-way
    validation figure, utils/logging.py:23-40)."""
    panels = [(m, t) for m, t in
              [(mel_pred, "predicted"), (mel_post, "postnet"),
               (mel_target, "target")] if m is not None]
    fig, axes = _fig(len(panels), figsize=(5 * len(panels), 4))
    if len(panels) == 1:
        axes = [axes]
    for ax, (mel, title) in zip(axes, panels):
        im = ax.imshow(np.asarray(mel), aspect="auto", origin="lower",
                       interpolation="none")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig
