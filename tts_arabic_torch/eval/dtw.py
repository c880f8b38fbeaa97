"""DTW alignment of feature sequences (the port's copy of the JAX
package's `eval/dtw.py`; reference `utils/oversmoothing.py:109-248`).

The JAX package runs the DP in a C++ library (`native/dtw.cc`) when it can
build one, and this numpy recurrence otherwise; the port keeps its own
copy of the numpy recurrence only (same metrics, window, path and cost)
and builds nothing of the JAX side. It is host code: evaluation scores
mels on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _dtw_numpy(A, B, metric: int, window: int):
    """Reference-identical recurrence, row-vectorized in numpy."""
    Ta, M = A.shape
    Tb = B.shape[0]
    inf = np.float32(1e30)
    D = np.full((Ta + 1, Tb + 1), inf, np.float32)
    D[0, 0] = 0.0
    P = np.full((Ta, Tb), -1, np.int8)
    for i in range(1, Ta + 1):
        j_min, j_max = 1, Tb
        if window >= 0:
            j_min = max(1, i - window)
            j_max = min(Tb, i + window)
        ai = A[i - 1]
        Bs = B[j_min - 1: j_max]
        if metric == 0:
            costs = np.sqrt(((ai[None, :] - Bs) ** 2).sum(1))
        else:
            denom = (np.linalg.norm(ai) * np.linalg.norm(Bs, axis=1) + 1e-12)
            costs = 1.0 - (Bs @ ai) / denom
        # the 'left' dependency is within-row sequential
        for idx, j in enumerate(range(j_min, j_max + 1)):
            up = D[i - 1, j]
            left = D[i, j - 1]
            diag = D[i - 1, j - 1]
            best, bp = up, 0
            if left < best:
                best, bp = left, 1
            if diag < best:
                best, bp = diag, 2
            D[i, j] = costs[idx] + best
            P[i - 1, j - 1] = bp
    i, j = Ta - 1, Tb - 1
    rev = []
    while i >= 0 and j >= 0:
        rev.append((i, j))
        bp = P[i, j]
        if bp == 2:
            i -= 1
            j -= 1
        elif bp == 0:
            i -= 1
        elif bp == 1:
            j -= 1
        else:
            rev.pop()  # unreachable: reference drops the final pair
            break
    return (float(D[Ta, Tb]),
            np.asarray(rev[::-1], np.int32).reshape(-1, 2))


def dtw_path(A: np.ndarray, B: np.ndarray, metric: str = "cosine",
             window: Optional[int] = None):
    """DTW between time-major feature sequences A [Ta, M], B [Tb, M].
    metric: "cosine" or "l2"; window: a Sakoe-Chiba band half-width, or
    None. Returns (total_cost, path [L, 2])."""
    mcode = 0 if metric.lower() == "l2" else 1
    w = -1 if window is None else int(window)
    return _dtw_numpy(np.asarray(A, np.float32), np.asarray(B, np.float32),
                      mcode, w)


def dtw_align_mels(mel_a: np.ndarray, mel_b: np.ndarray,
                   metric: str = "cosine", window: Optional[int] = None,
                   return_aligned: bool = True):
    """Align [B, T] mel spectrograms (reference `dtw_align_mels`,
    oversmoothing.py:202-248)."""
    A = np.ascontiguousarray(mel_a.T, np.float32)
    B = np.ascontiguousarray(mel_b.T, np.float32)
    total_cost, path = dtw_path(A, B, metric, window)
    if not return_aligned:
        return total_cost, path
    return total_cost, path, A[path[:, 0]], B[path[:, 1]]


def using_native_kernel() -> bool:
    """False: the port runs the numpy recurrence (a native DTW of its own
    is queued in ROADMAP.md)."""
    return False
