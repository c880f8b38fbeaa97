"""CTC loss of the aligner (counterpart of the JAX package's `ops/ctc.py`).

The JAX package computes it with its own scan, outside any Pallas kernel;
the port calls PyTorch's `F.ctc_loss`, as the reference's
`AttentionCTCLoss` did (`attn_loss_function.py:20-61`). The inputs must be
log-softmaxed: PyTorch's CTC backward returns the gradient with respect to
the logits under that normalisation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(log_probs: torch.Tensor, input_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood, blank at index 0.

    log_probs: [B, T, K] log-softmaxed over K; input_lens [B]; labels
    [B, N] right-padded, label_lens [B]. Returns [B]; a sequence with no
    feasible path gives 0 (`zero_infinity`), as the reference's did."""
    return F.ctc_loss(log_probs.transpose(0, 1), labels.to(torch.long),
                      input_lens.to(torch.long), label_lens.to(torch.long),
                      blank=0, reduction="none", zero_infinity=True)
