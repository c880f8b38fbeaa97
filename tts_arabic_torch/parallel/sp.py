"""Sequence-parallel vocoding: one utterance's time axis split over the
ranks of a mesh axis (the port's counterpart of the JAX package's
`parallel/sp.py`).

The generator is a feed-forward conv stack whose receptive field is about
+-13 mel frames (HiFi-GAN; Vocos about +-27 plus the ISTFT's overlap-add
edge), so a rank reproduces its core's waveform exactly from core +-
overlap frames of context. Each rank holds `core = ceil(F / n)` frames,
sends the outer 2 * overlap frames of its shard to its ring neighbours
(the edge ranks receive zeros, which their windows never read), vocodes a
window of core + 2 * overlap frames whose start is clamped into the
sequence (the edge ranks slide inward, so the utterance's boundary meets
the generator's own zero padding), and crops its core's samples. The
geometry is JAX's, offset for offset. The ranks' pieces are then gathered,
so every rank returns the whole wave, as JAX's array holds it.

On the gloo backend a halo is staged through host memory when the mel
lies on a card (gloo's point-to-point takes host tensors).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh, all_gather

LOG_MEL_SILENCE = -11.512925  # log(1e-5), the mel floor (audio/mel.py)


def _exchange(send_left: torch.Tensor, send_right: torch.Tensor,
              mesh: Mesh, axis: str):
    """Ring halos: this rank's `send_right` goes to its right neighbour and
    `send_left` to its left one; returns (from the left, from the right),
    zeros at the ends."""
    ranks = mesh.ranks(axis)
    d = mesh.axis_index(axis)
    n = len(ranks)
    staged = "gloo" in mesh.backend(axis) and send_left.device.type != "cpu"
    move = (lambda t: t.cpu()) if staged else (lambda t: t)
    left, right = (torch.zeros_like(move(send_left)),
                   torch.zeros_like(move(send_right)))
    ops = []
    if d > 0:
        ops += [dist.P2POp(dist.isend, move(send_left).contiguous(),
                           ranks[d - 1], mesh.group(axis)),
                dist.P2POp(dist.irecv, left, ranks[d - 1], mesh.group(axis))]
    if d < n - 1:
        ops += [dist.P2POp(dist.isend, move(send_right).contiguous(),
                           ranks[d + 1], mesh.group(axis)),
                dist.P2POp(dist.irecv, right, ranks[d + 1],
                           mesh.group(axis))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = send_left.device
    return left.to(dev), right.to(dev)


def sp_vocode(generator, mel: torch.Tensor, mesh: Mesh, *,
              axis: str = DATA_AXIS, overlap: int = 16,
              pad_value: float = LOG_MEL_SILENCE,
              batch_axis: str | None = None) -> torch.Tensor:
    """Vocode `mel` [B, F, C] -> wave [B, F * hop] with the time axis split
    over `mesh[axis]`; `generator` maps a mel [b, f, C] to its wave
    [b, f * hop]. Every rank of the axis passes the same mel and gets the
    whole wave back. On a 2-D mesh (`make_mesh_2d`) pass `axis=SEQ_AXIS,
    batch_axis=DATA_AXIS` to split the batch rows too (DP x SP: each
    row-group vocodes its rows, splitting each row's time axis).

    Matches the one-device `generator(mel)` for every F: when n does not
    divide F, the mel is padded with `pad_value` (log-mel silence) for the
    sharded pass, and the last `overlap` frames, the only ones whose
    context the padding reaches, are vocoded again from a tail window of
    the true sequence and spliced in. Below core < 2 * overlap frames a
    rank the plain call runs (too short to split)."""
    n = mesh.axis_size(axis)
    B, F, C = mel.shape
    if batch_axis is not None:
        if batch_axis == axis:
            raise ValueError("batch_axis must differ from the time axis "
                             f"(both {axis!r}); use make_mesh_2d")
        if B % mesh.axis_size(batch_axis):
            raise ValueError(f"batch {B} not divisible by "
                             f"mesh[{batch_axis!r}]="
                             f"{mesh.axis_size(batch_axis)}")
    core = -(-F // n)
    if n == 1 or core < 2 * overlap:
        wave = generator(mel)
        return wave[:, : F * (wave.shape[-1] // F)]
    F_pad = core * n
    mel_orig = mel
    if F_pad != F:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, F_pad - F),
                                      value=pad_value)
    if batch_axis is not None:
        rows = B // mesh.axis_size(batch_axis)
        i = mesh.axis_index(batch_axis)
        mel = mel[i * rows: (i + 1) * rows]

    window = core + 2 * overlap
    h = 2 * overlap
    # per-rank geometry (JAX's): window starts clamped into the sequence,
    # the selection offset inside the [2ov | core | 2ov] halo buffer, and
    # the mirrored crop offset
    starts = np.clip(np.arange(n) * core - overlap, 0, F_pad - window)
    sel_off = starts - (np.arange(n) * core - 2 * overlap)  # [2ov, ov.., 0]
    crop_off = np.arange(n) * core - starts                 # [0, ov.., 2ov]

    d = mesh.axis_index(axis)
    shard = mel[:, d * core: (d + 1) * core]
    from_left, from_right = _exchange(shard[:, :h], shard[:, -h:], mesh,
                                      axis)
    buf = torch.cat([from_left, shard, from_right], dim=1)
    win = buf[:, int(sel_off[d]): int(sel_off[d]) + window].contiguous()
    wave = generator(win)                           # [b, window * hop]
    hop = wave.shape[-1] // window
    piece = wave[:, int(crop_off[d]) * hop: (int(crop_off[d]) + core) * hop]
    out = all_gather(piece, mesh, axis, dim=1)      # [b, F_pad * hop]
    if batch_axis is not None:
        out = all_gather(out, mesh, batch_axis, dim=0)
    if F_pad == F:
        return out
    # the exact ragged tail: TAIL - overlap frames of true context exceed
    # the receptive field, so the spliced frames equal the full call's
    TAIL = min(8 * overlap, F)
    tail = generator(mel_orig[:, F - TAIL:].contiguous())
    return torch.cat([out[:, : (F - overlap) * hop],
                      tail[:, (TAIL - overlap) * hop:]], dim=-1)
