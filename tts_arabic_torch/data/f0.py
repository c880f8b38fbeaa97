"""Fundamental-frequency (f0) estimation for pitch conditioning (the port's
copy of the JAX package's `data/f0.py`, numpy and scipy only).

Probabilistic YIN (Mauch & Dixon 2014), the algorithm librosa's `pyin`
implements (reference `scripts/extract_f0.py:19`, C2..C7, frame 1024 /
hop 256):

 1. YIN difference function + cumulative-mean normalization (vectorized
    over frames via FFT autocorrelation)
 2. candidate extraction at ALL troughs of the normalized difference, with
    a 100-point threshold sweep under a Beta(2, 18) prior and a Boltzmann
    trough-rank prior
 3. Viterbi decoding over a voiced/unvoiced x pitch-bin HMM (10 bins per
    semitone, triangular local-transition window, 0.01 switch probability)

Unvoiced frames yield 0.0 (the reference maps librosa's NaN to 0,
`scripts/extract_f0.py:41`). `method="yin"` is the classic
single-threshold YIN on reflect-padded frames, faster but octave-fragile
on real speech. This is offline host preprocessing, not on the card.
"""
from __future__ import annotations

import numpy as np

C2 = 65.40639
C7 = 2093.0045
FRAME_LENGTH = 1024

# librosa.pyin defaults
_N_THRESHOLDS = 100
_BETA_A, _BETA_B = 2.0, 18.0
_BOLTZMANN = 2.0
_BINS_PER_SEMITONE = 10           # resolution=0.1
_MAX_TRANSITION_RATE = 35.92      # octaves per second
_SWITCH_PROB = 0.01
_NO_TROUGH_PROB = 0.01


def _frame(x: np.ndarray, frame_length: int, hop_length: int,
           pad_mode: str = "constant") -> np.ndarray:
    pad = frame_length // 2
    xp = np.pad(np.asarray(x, np.float64), pad, mode=pad_mode)
    n_frames = 1 + (len(xp) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    return xp[idx]


def _difference_function(frames: np.ndarray, max_tau: int) -> np.ndarray:
    """YIN difference d[t, tau] for tau in [0, max_tau), via FFT
    autocorrelation. frames: [N, W2] where the summation window is W2//2."""
    N, W2 = frames.shape
    W = W2 // 2
    # energy terms
    sq = frames**2
    csum = np.concatenate([np.zeros((N, 1)), np.cumsum(sq, axis=1)], axis=1)
    e0 = csum[:, W] - csum[:, 0]                        # [N]
    e_tau = csum[:, np.arange(max_tau) + W] - csum[:, :max_tau]  # [N, taus]
    # cross term via FFT correlation: r[tau] = sum_j x[j] x[j+tau]
    n_fft = 1 << int(np.ceil(np.log2(2 * W2)))
    F = np.fft.rfft(frames, n_fft, axis=1)
    Fw = np.fft.rfft(frames[:, :W], n_fft, axis=1)
    r = np.fft.irfft(F * np.conj(Fw), n_fft, axis=1)[:, :max_tau]
    return e0[:, None] + e_tau - 2.0 * r


def _cmndf(d: np.ndarray) -> np.ndarray:
    """Cumulative-mean-normalized difference; cmndf[:, 0] = 1."""
    tau = np.arange(1, d.shape[1])
    out = np.ones_like(d)
    cum = np.cumsum(d[:, 1:], axis=1)
    out[:, 1:] = d[:, 1:] * tau[None, :] / np.maximum(cum, 1e-12)
    return out


def _parabolic_shifts(y: np.ndarray) -> np.ndarray:
    """Sub-sample minimum refinement offsets for every interior tau."""
    shifts = np.zeros_like(y)
    y0, y1, y2 = y[:, :-2], y[:, 1:-1], y[:, 2:]
    denom = y0 - 2 * y1 + y2
    safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
    s = np.where(np.abs(denom) > 1e-12, 0.5 * (y0 - y2) / safe, 0.0)
    shifts[:, 1:-1] = np.clip(s, -0.5, 0.5)
    return shifts


# --- probabilistic YIN -------------------------------------------------------

def _boltzmann_pmf(k: np.ndarray, lam: float, N: np.ndarray) -> np.ndarray:
    """Truncated discrete exponential (scipy.stats.boltzmann.pmf):
    p(k) = (1 - e^-lam) e^(-lam k) / (1 - e^(-lam N)), 0 <= k < N."""
    N = np.maximum(N, 1)
    p = (1 - np.exp(-lam)) * np.exp(-lam * k) / (1 - np.exp(-lam * N))
    return np.where((k >= 0) & (k < N), p, 0.0)


def _trough_observations(yin: np.ndarray, shifts: np.ndarray, tau_min: int,
                         sample_rate: float, fmin: float,
                         n_pitch_bins: int):
    """Per-frame pitch-candidate probabilities -> HMM observation matrix.

    yin: cmndf restricted to [tau_min, tau_max); shifts: matching parabolic
    offsets. Returns obs [T, 2*n_pitch_bins] (voiced bins then unvoiced).
    """
    from scipy.stats import beta as beta_dist

    T, K = yin.shape
    thresholds = np.linspace(0.0, 1.0, _N_THRESHOLDS + 1)
    beta_probs = np.diff(beta_dist.cdf(thresholds, _BETA_A, _BETA_B))

    # local minima; index 0 is a trough when it starts descending
    # (librosa.util.localmin semantics on the restricted range)
    is_trough = np.empty_like(yin, dtype=bool)
    is_trough[:, 0] = yin[:, 0] < yin[:, 1]
    is_trough[:, 1:-1] = ((yin[:, 1:-1] <= yin[:, :-2])
                          & (yin[:, 1:-1] < yin[:, 2:]))
    is_trough[:, -1] = yin[:, -1] < yin[:, -2]

    obs = np.zeros((T, 2 * n_pitch_bins))
    log2_fs = 12 * _BINS_PER_SEMITONE
    for t in range(T):
        (idx,) = np.nonzero(is_trough[t])
        if idx.size == 0:
            obs[t, n_pitch_bins:] = 1.0 / n_pitch_bins
            continue
        heights = yin[t, idx]
        # rank of each trough among those below each threshold
        below = heights[:, None] < thresholds[None, 1:]   # [n_troughs, n_thr]
        ranks = np.cumsum(below, axis=0) - 1
        n_below = below.sum(axis=0)                        # per threshold
        prior = _boltzmann_pmf(ranks, _BOLTZMANN, n_below[None, :])
        prior = np.where(below, prior, 0.0)
        probs = prior @ beta_probs
        # thresholds with no trough below: mass to the global minimum,
        # attenuated (librosa no_trough_prob)
        probs[np.argmin(heights)] += (_NO_TROUGH_PROB
                                      * beta_probs[n_below == 0].sum())
        freqs = sample_rate / (tau_min + idx + shifts[t, idx])
        bins = np.round(log2_fs * np.log2(freqs / fmin)).astype(int)
        ok = (bins >= 0) & (bins < n_pitch_bins)
        np.add.at(obs[t], bins[ok], probs[ok])
        voiced_prob = min(obs[t, :n_pitch_bins].sum(), 1.0)
        obs[t, n_pitch_bins:] = (1.0 - voiced_prob) / n_pitch_bins
    return obs


def _viterbi_banded(obs: np.ndarray, n_pitch_bins: int, width: int):
    """Viterbi decode of the pyin HMM.

    Transition = kron([[1-p, p], [p, 1-p]], local) where `local` is a
    row-normalized triangular band of half-width `width`//2 over pitch bins
    (librosa `transition_local`). Row normalization is absorbed as a
    per-SOURCE-state penalty, which turns each step into one max-convolution
    with the triangle per block pair.
    """
    T = obs.shape[0]
    half = width // 2
    tri = (half + 1 - np.abs(np.arange(-half, half + 1))).astype(np.float64)
    log_tri = np.log(tri)
    # row normalizer: sum of the triangle clipped at the bin-range edges
    csum = np.concatenate([[0.0], np.cumsum(tri)])

    def norm(n):
        lo = np.maximum(np.arange(n) - half, 0) - (np.arange(n) - half)
        hi = np.minimum(np.arange(n) + half, n - 1) - (np.arange(n) - half)
        return csum[hi + 1] - csum[lo]

    log_norm = np.log(norm(n_pitch_bins))
    log_obs = np.log(np.maximum(obs, 1e-300))
    log_stay, log_switch = np.log1p(-_SWITCH_PROB), np.log(_SWITCH_PROB)

    # start unvoiced (librosa p_init)
    v = np.full(2 * n_pitch_bins, -np.inf)
    v[n_pitch_bins:] = -np.log(n_pitch_bins)
    v = v + log_obs[0]
    back = np.zeros((T, 2 * n_pitch_bins), np.int32)

    win = np.lib.stride_tricks.sliding_window_view
    offsets = np.arange(-half, half + 1)

    def band_max(scores):
        """max/argmax over j of scores[j] + log_tri[j - i] for each i."""
        padded = np.pad(scores, half, constant_values=-np.inf)
        w = win(padded, width) + log_tri[None, :]   # [n, width]
        arg = np.argmax(w, axis=1)
        return w[np.arange(len(scores)), arg], arg + offsets[0] + np.arange(
            len(scores))

    for t in range(1, T):
        sv = v[:n_pitch_bins] - log_norm    # absorb row normalization
        su = v[n_pitch_bins:] - log_norm
        mv, av = band_max(sv)
        mu, au = band_max(su)
        # into voiced block
        from_v = mv + log_stay
        from_u = mu + log_switch
        take_u = from_u > from_v
        new_v = np.where(take_u, from_u, from_v)
        back[t, :n_pitch_bins] = np.where(take_u, au + n_pitch_bins, av)
        # into unvoiced block
        from_v = mv + log_switch
        from_u = mu + log_stay
        take_u = from_u > from_v
        new_u = np.where(take_u, from_u, from_v)
        back[t, n_pitch_bins:] = np.where(take_u, au + n_pitch_bins, av)
        v = np.concatenate([new_v, new_u]) + log_obs[t]

    states = np.empty(T, np.int32)
    states[-1] = int(np.argmax(v))
    for t in range(T - 1, 0, -1):
        states[t - 1] = back[t, states[t]]
    return states


def _pyin_track(cmndf: np.ndarray, tau_min: int, tau_max: int,
                sample_rate: float, hop_length: int, fmin: float,
                fmax: float) -> np.ndarray:
    yin = cmndf[:, tau_min:tau_max]
    shifts = _parabolic_shifts(cmndf)[:, tau_min:tau_max]
    n_pitch_bins = int(np.floor(12 * _BINS_PER_SEMITONE
                                * np.log2(fmax / fmin))) + 1
    obs = _trough_observations(yin, shifts, tau_min, sample_rate, fmin,
                               n_pitch_bins)
    max_semitones = round(_MAX_TRANSITION_RATE * 12 * hop_length
                          / sample_rate)
    width = 2 * max_semitones * _BINS_PER_SEMITONE + 1
    states = _viterbi_banded(obs, n_pitch_bins, width)
    voiced = states < n_pitch_bins
    freqs = fmin * 2.0 ** ((states % n_pitch_bins)
                           / (12 * _BINS_PER_SEMITONE))
    return np.where(voiced, freqs, 0.0)


# --- classic single-threshold YIN -------------------------------------------

def _yin_track(cmndf: np.ndarray, tau_min: int, tau_max: int,
               sample_rate: float, fmin: float, fmax: float,
               threshold: float) -> np.ndarray:
    """Per frame: the first lag in [tau_min, tau_max) whose normalized
    difference falls below `threshold`, walked down to the local minimum
    after it and refined by a parabola; 0 where none falls below or the
    frequency leaves [fmin, fmax]."""
    region = cmndf[:, tau_min:tau_max]
    below = region < threshold
    voiced = below.any(axis=1)
    best = np.argmax(below, axis=1)
    rows = np.arange(len(best))
    for _ in range(tau_max):  # bounded walk, all frames at once
        nxt = np.minimum(best + 1, region.shape[1] - 1)
        go = (region[rows, nxt] < region[rows, best]) & voiced
        if not go.any():
            break
        best = np.where(go, nxt, best)
    best_tau = np.clip(best + tau_min, 1, tau_max - 2)
    tau_refined = best_tau + _parabolic_shifts(cmndf)[rows, best_tau]
    f0 = np.where(voiced, sample_rate / np.maximum(tau_refined, 1e-6), 0.0)
    return np.where((f0 >= fmin) & (f0 <= fmax), f0, 0.0)


def estimate_f0(x: np.ndarray, sample_rate: int = 22050,
                frame_length: int = FRAME_LENGTH, hop_length: int = 256,
                fmin: float = C2, fmax: float = C7,
                threshold: float = 0.15,
                method: str = "pyin") -> np.ndarray:
    """Per-frame f0 in Hz (0 = unvoiced), aligned with the mel frames.

    method="pyin" (default): probabilistic YIN, as the reference's
    librosa.pyin extraction (multi-threshold candidates + Viterbi voicing,
    robust to octave hops and noise). method="yin": the classic
    single-threshold YIN (`threshold`), faster but octave-fragile."""
    if method not in ("pyin", "yin"):
        raise ValueError(f"unknown f0 method '{method}'")
    frames = _frame(x, frame_length, hop_length,
                    "constant" if method == "pyin" else "reflect")
    tau_min = max(2, int(sample_rate / fmax))
    tau_max = min(int(sample_rate / fmin) + 1, frame_length // 2)
    cmndf = _cmndf(_difference_function(frames, tau_max))
    if method == "yin":
        f0 = _yin_track(cmndf, tau_min, tau_max, sample_rate, fmin, fmax,
                        threshold)
    else:
        f0 = _pyin_track(cmndf, tau_min, tau_max, sample_rate, hop_length,
                         fmin, fmax)
    return f0.astype(np.float32)


def extract_f0_dict(wav_paths, sample_rate: int = 22050,
                    hop_length: int = 256, method: str = "pyin"):
    """Batch-extract f0 for a corpus -> ({name: f0}, mean, std over voiced
    frames) (`scripts/extract_f0.py:25-78` equivalent)."""
    import os
    from ..audio.io import load_wav

    out = {}
    total, total_sq, count = 0.0, 0.0, 0
    for p in wav_paths:
        wave, _ = load_wav(p, target_sr=sample_rate)
        f0 = estimate_f0(wave, sample_rate, hop_length=hop_length,
                         method=method)
        out[os.path.basename(str(p))] = f0
        voiced = f0[f0 > 0]
        total += voiced.sum()
        total_sq += (voiced**2).sum()
        count += len(voiced)
    mean = total / max(count, 1)
    std = np.sqrt(max(total_sq / max(count, 1) - mean**2, 0.0))
    return out, float(mean), float(std)
