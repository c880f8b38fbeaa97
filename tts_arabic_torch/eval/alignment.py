"""Attention-alignment health scalars (the port's copy of the JAX package's
`eval/alignment.py`), logged per validation run: they catch the classic
silent failure of TTS training, an alignment that collapses onto one token
or wanders while the mel loss still falls.

Each function takes a soft attention map `attn [B, T_mel, T_txt]` whose
rows sum to about 1 over the text axis, and the true lengths; padded frames
and tokens are ignored."""
from __future__ import annotations

import torch

_BAND_FRAC, _MIN_BAND = 0.15, 2.0   # the diagonal band's half width


def _valid_frame_mask(attn, mel_lens):
    T_mel = attn.shape[1]
    return torch.arange(T_mel, device=attn.device)[None, :] < mel_lens[:, None]


def _peaks(attn, token_lens):
    T_txt = attn.shape[2]
    tok_ok = (torch.arange(T_txt, device=attn.device)[None, None, :]
              < token_lens[:, None, None])
    return torch.argmax(torch.where(tok_ok, attn, float("-inf")), dim=2), \
        tok_ok


def diagonal_band_mass(attn, mel_lens, token_lens):
    """Mean attention mass inside a band around the ideal diagonal: frame t
    of L_mel ideally attends token (t + 0.5) L_txt / L_mel, the band's half
    width is max(2, 0.15 L_txt) tokens. ~1 when healthy."""
    _, T_mel, T_txt = attn.shape
    mel_f = mel_lens.to(torch.float32)
    tok_f = token_lens.to(torch.float32)
    t = torch.arange(T_mel, dtype=torch.float32, device=attn.device)[None, :]
    pos = (t + 0.5) * (tok_f[:, None] / mel_f[:, None])
    half = torch.clamp(_BAND_FRAC * tok_f, min=_MIN_BAND)[:, None, None]
    j = torch.arange(T_txt, dtype=torch.float32,
                     device=attn.device)[None, None, :]
    in_band = (torch.abs(j - pos[:, :, None]) <= half) \
        & (j < tok_f[:, None, None])
    mass = torch.sum(attn * in_band, dim=2)
    fmask = _valid_frame_mask(attn, mel_lens).to(attn.dtype)
    return torch.sum(mass * fmask) / torch.clamp(torch.sum(fmask), min=1.0)


def peak_drift(attn, mel_lens, token_lens):
    """Mean excess |delta argmax| between consecutive valid frames, with
    one token of slack. ~0 for a clean monotonic alignment."""
    peaks, _ = _peaks(attn, token_lens)
    drift = torch.abs(torch.diff(peaks, dim=1)).to(torch.float32)
    excess = torch.clamp(drift - 1.0, min=0.0)
    fmask = _valid_frame_mask(attn, mel_lens)[:, 1:].to(torch.float32)
    return torch.sum(excess * fmask) / torch.clamp(torch.sum(fmask), min=1.0)


def token_coverage(attn, mel_lens, token_lens):
    """Fraction of real tokens that win the frame argmax at least once:
    ~1 for a complete alignment, ~1/L_txt for a collapsed one."""
    T_txt = attn.shape[2]
    peaks, tok_ok = _peaks(attn, token_lens)
    fmask = _valid_frame_mask(attn, mel_lens).to(torch.float32)
    onehot = (peaks[..., None] == torch.arange(T_txt, device=attn.device))
    won = (onehot.to(torch.float32) * fmask[:, :, None]).amax(dim=1)
    covered = torch.sum(won * tok_ok[:, 0, :], dim=1)
    return torch.mean(covered / torch.clamp(token_lens.to(torch.float32),
                                            min=1.0))


def alignment_diagnostics(attn, mel_lens, token_lens) -> dict:
    """`attn_diag_mass` (~1 healthy), `attn_peak_drift` (~0 healthy) and
    `attn_coverage` (~1 healthy), as 0-d tensors."""
    return {
        "attn_diag_mass": diagonal_band_mass(attn, mel_lens, token_lens),
        "attn_peak_drift": peak_drift(attn, mel_lens, token_lens),
        "attn_coverage": token_coverage(attn, mel_lens, token_lens),
    }
