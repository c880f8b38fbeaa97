"""DTW alignment of feature sequences (the port's counterpart of the JAX
package's `eval/dtw.py`; reference `utils/oversmoothing.py:109-248`).

The DP runs in the port's own host C++ library (`csrc/dtw.cc`, built at
first use by `ops.build.host_library` into `build/`, called through
ctypes): metrics L2 and cosine, a Sakoe-Chiba window, the reference's
path. A library that cannot be built or loaded raises; nothing falls back.
`_dtw_numpy`, the same recurrence in numpy (a Python loop over the cells),
is the plain version the tests hold it against. Evaluation scores mels on
the host, so this is host code.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..ops.build import host_library

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _library() -> ctypes.CDLL:
    lib = host_library("dtw")
    fn = lib.tts_dtw_path
    fn.argtypes = [_F32P, _F32P] + [ctypes.c_int] * 5 + [_F32P, _I32P,
                                                         _I32P]
    fn.restype = ctypes.c_int
    return lib


def _dtw_native(A: np.ndarray, B: np.ndarray, metric: int, window: int):
    """The C++ recurrence: (total cost, path [L, 2] int32)."""
    A = np.ascontiguousarray(A, np.float32)
    B = np.ascontiguousarray(B, np.float32)
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[1]:
        raise ValueError(f"DTW of {A.shape} against {B.shape}: two "
                         "[T, M] sequences of one width")
    Ta, M = A.shape
    Tb = B.shape[0]
    cost = ctypes.c_float()
    path = np.empty((Ta + Tb, 2), np.int32)
    n = ctypes.c_int32()
    rc = _library().tts_dtw_path(A.ctypes.data_as(_F32P),
                                 B.ctypes.data_as(_F32P), Ta, Tb, M, metric,
                                 window, ctypes.byref(cost),
                                 path.ctypes.data_as(_I32P), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"DTW of {A.shape} against {B.shape} "
                         f"(metric {metric}) refused")
    return float(cost.value), path[: n.value].copy()


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
    None. Returns (total_cost, path [L, 2]), from the native library."""
    mcode = 0 if metric.lower() == "l2" else 1
    w = -1 if window is None else int(window)
    return _dtw_native(A, B, mcode, w)


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
    """True once the native library is built and loaded (it raises
    otherwise)."""
    return _library() is not None
