"""Datasets and batching for FastPitch and Tacotron2 training (host-side
numpy; the port's copy of the JAX package's `data/dataset.py`, the
vocoder's segments aside).

- label-file parsing via a regex with named groups arabic / phonemes /
  buckwalter and filename / filestem (reference `_process_line`,
  `utils/data.py:78-97`)
- wav -> 22050 Hz log-mel (clamp 1e-5), internal-silence stripping below
  -10 mean-log energy with trailing silence kept (`remove_silence`,
  data.py:59-67)
- FastPitch extras: f0 lookup + zero-preserving normalization
  (data.py:50-57), L2-over-bins energy, beta-binomial prior
  (data.py:248-250)
- length-bucketed dynamic batching (`DynBatchDataset`, data.py:258-307)

`collate_fastpitch` and `collate_tacotron` pad text to multiples of 16
and mel to multiples of 64, as the JAX package does, so the two see the
same batch shapes. `WeightedSampler` draws the balanced-sampling order
(reference train.py:150-156). Audio is
read at the mel frontend's 22050 Hz (`MelConfig`), resampled where a wav
has another rate.
"""
from __future__ import annotations

import os
import pathlib
import re
import wave as wavmod
from typing import List

import numpy as np

from .. import text as text_frontend
from ..align.prior import BetaBinomialInterpolator
from ..audio.io import load_wav
from ..audio.mel import MelConfig, log_mel_numpy

DEFAULT_LABEL_PATTERN = '"(?P<filename>.*)" "(?P<phonemes>.*)"'
TEXT_PAD, MEL_PAD = 16, 64      # collate's multiples of T_txt and T_mel


def parse_label_line(pattern: str, line: str):
    """(phonemes, filename) from one label line (data.py:78-97)."""
    match = re.search(pattern, line)
    if match is None:
        raise ValueError(f"no match for line: {line!r}")
    d = match.groupdict()
    if "arabic" in d:
        phonemes = text_frontend.arabic_to_phonemes(d["arabic"])
    elif "phonemes" in d:
        phonemes = d["phonemes"]
    elif "buckwalter" in d:
        phonemes = text_frontend.buckwalter_to_phonemes(d["buckwalter"])
    else:
        raise ValueError("pattern must capture arabic/phonemes/buckwalter")
    if "filename" in d:
        filename = d["filename"]
    elif "filestem" in d:
        filename = f"{d['filestem']}.wav"
    else:
        raise ValueError("pattern must capture filename/filestem")
    return phonemes, filename


def normalize_pitch(pitch: np.ndarray, mean: float, std: float) -> np.ndarray:
    """Zero-preserving z-score (data.py:50-57)."""
    zeros = pitch == 0.0
    out = (pitch - mean) / std
    out[zeros] = 0.0
    return out


def silence_keep_mask(energy_per_frame: np.ndarray,
                      thresh: float = -10.0) -> np.ndarray:
    """Frames to keep: energy above thresh, plus all trailing silence
    (data.py:59-67 keeps the tail run of silent frames)."""
    keep = energy_per_frame > thresh
    i = len(keep) - 1
    while i > 0 and not keep[i]:
        keep[i] = True
        i -= 1
    return keep


class ArabDataset:
    """Tokenized transcript + log-mel dataset (reference `ArabDataset`,
    data.py:100-167). Lines that do not parse, name a missing wav or hold
    unknown phonemes are reported and skipped, as the reference does."""

    def __init__(self, txtpath, wavpath,
                 label_pattern: str = DEFAULT_LABEL_PATTERN,
                 cache: bool = False):
        self.wav_path = pathlib.Path(wavpath)
        self.mel_cfg = MelConfig()
        self.cache = {} if cache else None
        self.data = self._load_index(txtpath, label_pattern)

    def _load_index(self, txtpath, pattern):
        entries = []
        for l_idx, line in enumerate(
                pathlib.Path(txtpath).read_text().splitlines()):
            if not line.strip():
                continue
            try:
                phonemes, filename = parse_label_line(pattern, line)
            except ValueError:
                print(f"invalid line {l_idx}: {line}")
                continue
            fpath = self.wav_path / filename
            if not fpath.exists():
                print(f"{fpath} does not exist")
                continue
            try:
                tokens = text_frontend.phonemes_to_tokens(phonemes)
                token_ids = np.asarray(text_frontend.tokens_to_ids(tokens),
                                       np.int32)
            except KeyError:
                print(f"invalid phonemes at line {l_idx}: {line}")
                continue
            entries.append((token_ids, fpath, phonemes))
        return entries

    def _load_logmel(self, fpath):
        """-> (log-mel [80, T] with the internal silence cut, the kept
        frames' mask, the wave at the mel's rate)."""
        wave, _ = load_wav(fpath, target_sr=self.mel_cfg.sample_rate)
        mel_log = log_mel_numpy(wave, self.mel_cfg)
        keep = silence_keep_mask(mel_log.mean(0))
        return mel_log[:, keep], keep, wave

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        """(token ids [n] int32, log-mel [80, T])."""
        if self.cache is not None and idx in self.cache:
            return self.cache[idx]
        token_ids, fpath, _ = self.data[idx]
        item = (token_ids, self._load_logmel(fpath)[0])
        if self.cache is not None:
            self.cache[idx] = item
        return item


class ArabDatasetFastPitch(ArabDataset):
    """+ f0, energy, beta-binomial prior (reference `ArabDataset4FastPitch`,
    data.py:170-255). The f0 dict is a `.npz` ({wav_name: f0_per_frame}) or
    a torch `.pt` from the reference's extract_f0 script; without one, f0
    is estimated with pYIN on the fly."""

    def __init__(self, txtpath, wavpath,
                 label_pattern: str = DEFAULT_LABEL_PATTERN,
                 f0_dict_path=None, f0_mean: float = 130.05478,
                 f0_std: float = 22.86267, cache: bool = False):
        super().__init__(txtpath, wavpath, label_pattern, cache)
        self.f0_mean = f0_mean
        self.f0_std = f0_std
        self.prior = BetaBinomialInterpolator()
        self.f0_dict = self._load_f0(f0_dict_path) if f0_dict_path else None

    @staticmethod
    def _load_f0(path):
        path = str(path)
        if path.endswith(".npz"):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        import torch
        raw = torch.load(path, map_location="cpu", weights_only=True)
        return {k: np.asarray(v) for k, v in raw.items()}

    def __getitem__(self, idx):
        if self.cache is not None and idx in self.cache:
            return self.cache[idx]
        item = self._compute_item(idx)
        if self.cache is not None:
            self.cache[idx] = item
        return item

    def _compute_item(self, idx):
        token_ids, fpath, _ = self.data[idx]
        mel_log, keep, wave = self._load_logmel(fpath)

        if self.f0_dict is not None:
            f0 = np.asarray(self.f0_dict[os.path.basename(str(fpath))],
                            np.float32)
        else:
            from .f0 import estimate_f0
            f0 = estimate_f0(wave, self.mel_cfg.sample_rate,
                             hop_length=self.mel_cfg.hop_length)
        f0 = f0[: len(keep)][keep[: len(f0)]]
        pitch = normalize_pitch(f0.copy(), self.f0_mean,
                                self.f0_std)[None, :]  # [1, T]
        if pitch.shape[1] < mel_log.shape[1]:
            pitch = np.pad(pitch,
                           ((0, 0), (0, mel_log.shape[1] - pitch.shape[1])))
        pitch = pitch[:, : mel_log.shape[1]]

        energy = np.linalg.norm(mel_log, ord=2, axis=0)
        attn_prior = self.prior(mel_log.shape[1], len(token_ids))
        return {
            "token_ids": token_ids,
            "mel": mel_log,            # [80, T]
            "pitch": pitch,            # [1, T]
            "energy": energy,          # [T]
            "attn_prior": attn_prior,  # [T, n_tokens]
        }


class DynBatchDataset:
    """Mel-length-bucketed dynamic batching (reference `DynBatchDataset`,
    data.py:258-307): bucket limits `max_lengths` with per-bucket batch
    sizes; `shuffle()` rebuilds the id batches each epoch."""

    def __init__(self, dataset: ArabDatasetFastPitch,
                 max_lengths=(1000, 1300, 1850, 30000),
                 batch_sizes=(10, 8, 6, 4)):
        self.dataset = dataset
        self.bounds = [0] + list(max_lengths)
        self.batch_sizes = list(batch_sizes)
        self.rng = np.random.default_rng(0)
        self.lengths = [self._estimate_len(i) for i in range(len(dataset))]
        self.id_batches = []
        self.shuffle()

    def _estimate_len(self, i):
        # mel frames ~ wav samples / hop; avoids decoding audio up front
        _, fpath, _ = self.dataset.data[i]
        with wavmod.open(str(fpath), "rb") as w:
            n = w.getnframes()
            sr = w.getframerate()
        mel_cfg = self.dataset.mel_cfg
        return int(n * mel_cfg.sample_rate / sr / mel_cfg.hop_length)

    def shuffle(self):
        per_bs = {b: [] for b in self.batch_sizes}
        for i, L in enumerate(self.lengths):
            b_idx = next(k for k in range(len(self.bounds) - 1)
                         if self.bounds[k] <= L < self.bounds[k + 1])
            per_bs[self.batch_sizes[b_idx]].append(i)
        batches = []
        for bs, ids in per_bs.items():
            ids = list(ids)
            self.rng.shuffle(ids)
            batches += [ids[k: k + bs] for k in range(0, len(ids), bs)]
        self.rng.shuffle(batches)
        self.id_batches = batches

    def __len__(self):
        return len(self.id_batches)

    def __getitem__(self, idx):
        return [self.dataset[i] for i in self.id_batches[idx]]


def _ceil_to(n, m):
    return ((n + m - 1) // m) * m


def collate_fastpitch(batch: List[dict]) -> dict:
    """Pad a list of ArabDatasetFastPitch items to bucket shapes.

    Returns feature-last numpy arrays for the FastPitch train step:
    tokens [B, T_txt], mel_tgt [B, T_mel, 80], pitch_dense [B, 1, T_mel],
    energy_dense [B, T_mel], attn_prior [B, T_mel, T_txt], token_lens and
    mel_lens [B].
    """
    B = len(batch)
    t_max = _ceil_to(max(len(s["token_ids"]) for s in batch), TEXT_PAD)
    m_max = _ceil_to(max(s["mel"].shape[1] for s in batch), MEL_PAD)
    n_mels = batch[0]["mel"].shape[0]

    tokens = np.zeros((B, t_max), np.int32)
    token_lens = np.zeros((B,), np.int32)
    mel = np.zeros((B, m_max, n_mels), np.float32)
    mel_lens = np.zeros((B,), np.int32)
    pitch = np.zeros((B, 1, m_max), np.float32)
    energy = np.zeros((B, m_max), np.float32)
    prior = np.zeros((B, m_max, t_max), np.float32)

    for i, s in enumerate(batch):
        nt = len(s["token_ids"])
        nm = s["mel"].shape[1]
        tokens[i, :nt] = s["token_ids"]
        token_lens[i] = nt
        mel[i, :nm] = s["mel"].T
        mel_lens[i] = nm
        pitch[i, :, :nm] = s["pitch"][:, :nm]
        energy[i, :nm] = s["energy"][:nm]
        prior[i, :nm, :nt] = s["attn_prior"][:nm, :nt]

    return {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
            "mel_lens": mel_lens, "pitch_dense": pitch,
            "energy_dense": energy, "attn_prior": prior}


def collate_tacotron(batch: List[tuple]) -> dict:
    """Pad (token_ids, log_mel) pairs; the gate target is 1 from each
    sample's last frame onward (reference `text_mel_collate_fn`,
    data.py:13-47). Returns tokens [B, T_txt], token_lens, mel_tgt
    [B, T_mel, 80] feature-last, gate_tgt [B, T_mel] and mel_lens."""
    B = len(batch)
    t_max = _ceil_to(max(len(t) for t, _ in batch), TEXT_PAD)
    m_max = _ceil_to(max(m.shape[1] for _, m in batch), MEL_PAD)
    n_mels = batch[0][1].shape[0]

    tokens = np.zeros((B, t_max), np.int32)
    token_lens = np.zeros((B,), np.int32)
    mel = np.zeros((B, m_max, n_mels), np.float32)
    gate = np.zeros((B, m_max), np.float32)
    mel_lens = np.zeros((B,), np.int32)
    for i, (t, m) in enumerate(batch):
        tokens[i, : len(t)] = t
        token_lens[i] = len(t)
        mel[i, : m.shape[1]] = m.T
        gate[i, m.shape[1] - 1:] = 1.0
        mel_lens[i] = m.shape[1]
    return {"tokens": tokens, "token_lens": token_lens, "mel_tgt": mel,
            "gate_tgt": gate, "mel_lens": mel_lens}


class WeightedSampler:
    """Weighted sampling without replacement (reference `train.py:150-156`
    balanced_sampling through torch's WeightedRandomSampler; the weights
    file from `data/sampler/`): each epoch an order of every id, biased by
    the weights, from numpy's generator seeded `seed` (the JAX package's
    draws)."""

    def __init__(self, weights, seed: int = 0):
        self.weights = np.asarray(weights, np.float64)
        self.weights = self.weights / self.weights.sum()
        self.rng = np.random.default_rng(seed)

    @classmethod
    def from_file(cls, path, seed: int = 0):
        """Weights from a `.npy`, a `.npz` (its first array) or a torch
        file holding a tensor or a list."""
        path = str(path)
        if path.endswith(".npy") or path.endswith(".npz"):
            w = np.load(path)
            if hasattr(w, "files"):
                w = w[w.files[0]]
        else:
            import torch
            w = np.asarray(torch.load(path, map_location="cpu",
                                      weights_only=True))
        return cls(w, seed)

    def sample(self, n=None):
        n = n if n is not None else len(self.weights)
        return self.rng.choice(len(self.weights), size=n, replace=False,
                               p=self.weights)
