"""Beta-binomial alignment prior (host-side preprocessing; the port's copy
of the JAX package's `align/prior.py`).

The text<->mel diagonal prior P[m, p] = BetaBinom(P-1; a=m+1, b=M-m),
evaluated per mel frame (reference `data_function.py:45-78`), with an
interpolating cache over rounded sizes so long utterances reuse zoomed
versions of a few computed banks.
"""
from __future__ import annotations

import functools

import numpy as np
from scipy import ndimage
from scipy.stats import betabinom


@functools.lru_cache(maxsize=64)
def beta_binomial_prior(phoneme_count: int, mel_count: int) -> np.ndarray:
    """[mel_count, phoneme_count] prior matrix (data_function.py:68-78,
    scaling 1)."""
    P, M = phoneme_count, mel_count
    x = np.arange(P)
    rows = [betabinom(P, i, M + 1 - i).pmf(x) for i in range(1, M + 1)]
    return np.asarray(rows, dtype=np.float32)


class BetaBinomialInterpolator:
    """Cache priors at sizes rounded to 100 mel frames and 20 tokens,
    interpolate to the requested size (data_function.py:45-65). Call with
    (mel_len, text_len)."""

    round_mel, round_text = 100, 20

    @staticmethod
    def _round(val: int, to: int) -> int:
        return max(1, int(np.round((val + 1) / to))) * to

    def __call__(self, mel_len: int, text_len: int) -> np.ndarray:
        bw = self._round(mel_len, self.round_mel)
        bh = self._round(text_len, self.round_text)
        # the reference computes the cached bank with (phoneme_count =
        # rounded mel, mel_count = rounded text) and transposes it, so each
        # TEXT column is a BetaBinomial over mel frames; kept for parity
        bank = beta_binomial_prior(bw, bh).T  # [bw, bh]
        out = ndimage.zoom(bank, zoom=(mel_len / bw, text_len / bh), order=1)
        if out.shape != (mel_len, text_len):
            raise ValueError(f"prior zoomed to {out.shape}, expected "
                             f"{(mel_len, text_len)}")
        return out.astype(np.float32)
