"""Cepstral oversmoothing metrics, DTW-aligned comparisons and MCD (the
port's copy of the JAX package's `eval/oversmoothing.py`; reference
`utils/oversmoothing.py:306-632`): per-frame rFFT power across mel bins,
HQER / CSlope / CCentroid / CRoll95, their DTW-aligned prediction-vs-
reference deltas, and mel cepstral distortion. Numpy on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .dtw import dtw_path


def _reduce(x, reduction):
    if reduction == "mean":
        return float(np.nanmean(x))
    if reduction == "median":
        return float(np.nanmedian(x))
    return x


def framewise_rfft_power(mel: np.ndarray, center: bool = True,
                         hann: bool = True) -> np.ndarray:
    """[B, T] mel -> quefrency power |C(q, t)|^2 of shape [B//2+1, T]."""
    X = mel.astype(np.float32, copy=False)
    if center:
        X = X - X.mean(axis=0, keepdims=True)
    if hann:
        X = X * np.hanning(X.shape[0]).astype(np.float32)[:, None]
    C = np.fft.rfft(X, axis=0)
    return C.real**2 + C.imag**2


def hqer_from_power(P, q_c: Optional[int] = None, reduction="none"):
    Q = P.shape[0]
    if q_c is None:
        q_c = max(1, min(int(np.floor(0.25 * Q)), Q - 1))
    denom = P[1:].sum(axis=0) + 1e-12
    numer = P[q_c:].sum(axis=0)
    return _reduce(numer / denom, reduction)


def slope_from_power(P, q1: int = 1, q2: Optional[int] = None,
                     eps: float = 1e-8, reduction="none"):
    Q = P.shape[0]
    q2 = Q - 1 if q2 is None else q2
    q = np.arange(q1, q2 + 1, dtype=np.float32)
    if q.size < 2:
        return float("nan")
    P_db = 10 * np.log10(P[q1: q2 + 1] + eps)
    q_mean = q.mean()
    q_var = ((q - q_mean) ** 2).mean() + 1e-12
    cov = ((q[:, None] - q_mean) * (P_db - P_db.mean(axis=0))).mean(axis=0)
    return _reduce(cov / q_var, reduction)


def centroid_from_power(P, reduction="none"):
    Q = P.shape[0]
    q = np.arange(Q, dtype=np.float32)
    denom = P[1:].sum(axis=0) + 1e-12
    num = (q[1:, None] * P[1:]).sum(axis=0)
    return _reduce(num / denom, reduction)


def rolloff_from_power(P, p: float = 0.95, reduction="none"):
    P = P.copy()
    P[0] = 0.0
    cum = np.cumsum(P, axis=0)
    target = p * (cum[-1] + 1e-12)
    ge = cum >= target[None, :]
    idx = np.where(ge.any(axis=0), ge.argmax(axis=0), 1).astype(np.float32)
    return _reduce(idx, reduction)


def compute_mel_oversmoothing_metrics(mel: np.ndarray, center: bool = True,
                                      hann: bool = True,
                                      q_c: Optional[int] = None,
                                      reduction: str = "none") -> Dict:
    """Per-utterance cepstral oversmoothing metrics (reference
    `compute_mel_oversmoothing_metrics`, oversmoothing.py:524-569)."""
    P = framewise_rfft_power(mel, center, hann)
    return {
        "HQER": 100 * hqer_from_power(P, q_c=q_c, reduction=reduction),
        "CSlope": slope_from_power(P, reduction=reduction),
        "CCentroid": centroid_from_power(P, reduction=reduction),
        "CRoll95": rolloff_from_power(P, p=0.95, reduction=reduction),
        "Q": int(P.shape[0]),
    }


def _nan_interp(x):
    x = np.asarray(x, np.float64).copy()
    nans = ~np.isfinite(x)
    if nans.all():
        return np.zeros_like(x)
    if nans.any():
        idx = np.arange(len(x))
        x[nans] = np.interp(idx[nans], idx[~nans], x[~nans])
    return x


def _zscore(x):
    m, s = np.nanmean(x), np.nanstd(x)
    if not np.isfinite(s) or s == 0.0:
        return np.zeros_like(x, np.float32)
    return ((x - m) / s).astype(np.float32)


def aligned_mae_distance(series_pred, series_ref) -> float:
    """MAE between two 1D series after DTW alignment (oversmoothing.py:
    250-303): the path is computed on z-scored NaN-interpolated copies and
    applied to the originals."""
    a = _zscore(_nan_interp(series_pred))[:, None]
    b = _zscore(_nan_interp(series_ref))[:, None]
    _, path = dtw_path(a, b, metric="l2")
    return float(np.nanmean(np.abs(series_pred[path[:, 0]]
                                   - series_ref[path[:, 1]])))


def oversmoothing_metrics_aligned(mel_pred: np.ndarray, mel_ref: np.ndarray,
                                  center: bool = True,
                                  hann: bool = True) -> Dict[str, float]:
    """DTW-aligned oversmoothing errors (oversmoothing.py:572-632)."""
    sp = compute_mel_oversmoothing_metrics(mel_pred, center, hann)
    sr = compute_mel_oversmoothing_metrics(mel_ref, center, hann)
    out = {}
    for k in sp:
        if not isinstance(sp[k], np.ndarray):
            continue
        out[f"mae_{k}"] = aligned_mae_distance(sp[k], sr[k])
        out[f"delta_u_{k}"] = float(np.nanmedian(sp[k])
                                    - np.nanmedian(sr[k]))
    return out


def mcd(mel_pred: np.ndarray, mel_ref: np.ndarray, n_coeffs: int = 13,
        align: bool = True) -> float:
    """Mel cepstral distortion (dB) between [B, T] log-mels — the headline
    parity metric (BASELINE.md). Cepstra via DCT over mel bins; frame pairs
    by DTW when lengths differ."""
    from scipy.fftpack import dct

    def cepstra(m):
        return dct(m, axis=0, norm="ortho")[1: n_coeffs + 1].T  # [T, C]

    ca, cb = cepstra(mel_pred), cepstra(mel_ref)
    if align and ca.shape[0] != cb.shape[0]:
        _, path = dtw_path(np.ascontiguousarray(ca),
                           np.ascontiguousarray(cb), metric="l2")
        ca, cb = ca[path[:, 0]], cb[path[:, 1]]
    n = min(len(ca), len(cb))
    diff = ca[:n] - cb[:n]
    return float(np.mean(np.sqrt((diff**2).sum(axis=1)))
                 * (10.0 / np.log(10.0)) * np.sqrt(2.0))
