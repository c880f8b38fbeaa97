"""Signal framing (the part of the JAX package's `audio/mel.py` the
inference path needs; the mel frontend comes with the training slice)."""
from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop: int) -> torch.Tensor:
    """Slice [..., T] into overlapping frames [..., n_frames, frame_length]
    (a strided view, no copy)."""
    return x.unfold(-1, frame_length, hop)
