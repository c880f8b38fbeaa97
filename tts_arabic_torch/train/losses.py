"""Training losses (the port's copy of the JAX package's `train/losses.py`):
FastPitch's masked mel MSE, log-duration MSE, pitch MSE, energy MSE x0.1
and the attention CTC loss (reference `loss_function.py:45-123`), the
attention binarization KL (`attn_loss_function.py:64-71`), and
Tacotron2's mel, postnet-mel and gate loss
(`models/tacotron2/loss.py:5-33`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.layers import sequence_mask
from ..ops.ctc import ctc_loss

_NEG_INF = -1e9
_BLANK_LOGPROB = -1.0   # the CTC blank's score in every attention row
_EPS = 1e-12
_ENERGY_SCALE = 0.1     # the energy MSE's weight; every other term has 1


def attention_ctc_loss(attn_logprob, token_lens, mel_lens):
    """Forces the soft alignment to cover every text position in order
    (reference `AttentionCTCLoss`): each attention row is an emission over
    the text positions plus a blank at index 0, the target 1..token_len.

    attn_logprob: [B, T_mel, T_txt]; returns the batch mean of each
    sequence's loss over its target length."""
    B, T_mel, T_txt = attn_logprob.shape
    logits = torch.nn.functional.pad(attn_logprob, (1, 0),
                                     value=_BLANK_LOGPROB)
    key_ids = torch.arange(T_txt + 1, device=attn_logprob.device)
    valid_keys = key_ids[None, None, :] <= token_lens[:, None, None]
    logits = torch.where(valid_keys, logits, _NEG_INF)
    log_probs = torch.log_softmax(logits, dim=-1)
    labels = key_ids[1:][None, :].expand(B, T_txt)
    per_seq = ctc_loss(log_probs, mel_lens, labels, token_lens)
    return torch.mean(per_seq / torch.clamp(token_lens, min=1))


def attention_binarization_loss(attn_hard, attn_soft):
    """-log soft-attention mass under the hard alignment."""
    log_sum = torch.sum(torch.where(
        attn_hard == 1.0, torch.log(torch.clamp(attn_soft, min=_EPS)), 0.0))
    return -log_sum / torch.clamp(torch.sum(attn_hard), min=1.0)


def fastpitch_loss(out: dict, batch: dict):
    """Composite FastPitch loss. `out` is `FastPitch.forward_train`'s dict;
    `batch` provides mel_tgt [B, T_mel, n_mel], token_lens and mel_lens.
    Returns (loss, meta)."""
    token_lens = batch["token_lens"]
    mel_tgt = batch["mel_tgt"]

    dur_mask = sequence_mask(token_lens, out["dur_tgt"].shape[1]).to(
        torch.float32)
    n_tok = torch.sum(dur_mask)

    log_dur_tgt = torch.log(out["dur_tgt"] + 1.0)
    dur_loss = torch.sum(
        (out["log_dur_pred"] - log_dur_tgt) ** 2 * dur_mask) / n_tok

    # elementwise nonzero mask (reference loss_function.py:80-83)
    mel_mask = (mel_tgt != 0.0).to(torch.float32)
    mel_loss = torch.sum((out["mel_out"] - mel_tgt) ** 2 * mel_mask) \
        / torch.clamp(torch.sum(mel_mask), min=1.0)

    pitch_loss = torch.sum(
        (out["pitch_tgt"] - out["pitch_pred"]) ** 2 * dur_mask[:, None, :]
    ) / n_tok

    has_energy = out.get("energy_pred") is not None
    energy_loss = 0.0
    if has_energy:
        energy_loss = torch.sum(
            (out["energy_tgt"] - out["energy_pred"]) ** 2 * dur_mask) / n_tok

    attn_loss = attention_ctc_loss(out["attn_logprob"], token_lens,
                                   batch["mel_lens"])

    loss = (mel_loss + dur_loss + pitch_loss + _ENERGY_SCALE * energy_loss
            + attn_loss)
    meta = {
        "loss": loss,
        "mel_loss": mel_loss,
        "duration_predictor_loss": dur_loss,
        "pitch_loss": pitch_loss,
        "attn_loss": attn_loss,
        "dur_error": torch.sum(torch.abs(out["dur_pred"] - out["dur_tgt"])
                               * dur_mask) / n_tok,
    }
    if has_energy:
        meta["energy_loss"] = energy_loss
    return loss, meta


def tacotron2_loss(mel_out, mel_out_postnet, gate_out, mel_tgt, gate_tgt,
                   mel_lens):
    """MSE(mel) + MSE(postnet mel) + BCE(gate), each masked to the frames
    inside each length. Shapes: mel [B, T, n_mel] feature-last, gate
    [B, T]. Returns (loss, meta)."""
    frame_mask = sequence_mask(mel_lens, mel_out.shape[1]).to(torch.float32)
    m = frame_mask[..., None]
    denom = torch.clamp(torch.sum(m) * mel_out.shape[-1], min=1.0)
    mel_loss = torch.sum((mel_out - mel_tgt) ** 2 * m) / denom
    post_loss = torch.sum((mel_out_postnet - mel_tgt) ** 2 * m) / denom
    # optax's sigmoid_binary_cross_entropy
    gate_bce = -(gate_tgt * F.logsigmoid(gate_out)
                 + (1.0 - gate_tgt) * F.logsigmoid(-gate_out))
    gate_loss = torch.sum(gate_bce * frame_mask) / torch.clamp(
        torch.sum(frame_mask), min=1.0)
    loss = mel_loss + post_loss + gate_loss
    meta = {"loss": loss, "mel_loss": mel_loss, "post_mel_loss": post_loss,
            "gate_loss": gate_loss}
    return loss, meta
