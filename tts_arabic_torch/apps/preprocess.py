"""Corpus preprocessing CLIs (the port's counterpart of the JAX
package's `apps/preprocess.py`; reference `scripts/preprocess_audio.py`,
`scripts/preprocess_text.py`, `scripts/extract_f0.py`).

    python -m tts_arabic_torch.apps.preprocess audio --in-dir wav/ \
        --out-dir wav_new/
    python -m tts_arabic_torch.apps.preprocess text \
        --transcript orthographic.txt --out-dir data/
    python -m tts_arabic_torch.apps.preprocess f0 --wav-dir wav_new/ \
        --out data/pitch_dict.npz

Host work only (scipy resampling, numpy pYIN): nothing here runs on the
card.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from .. import text as text_frontend
from ..audio import (load_wav, peak_normalize, save_wav, trim_silence_db)
from ..data.f0 import extract_f0_dict


def preprocess_audio(in_dir, out_dir, sr: int = 22050, top_db: float = 23.0,
                     pad_samples: int = 768):
    """Resample -> peak-normalize 0.999 -> trim(top_db) -> append zero pad
    (preprocess_audio.py:28-47)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    wavs = sorted(pathlib.Path(in_dir).glob("**/*.wav"))
    for p in wavs:
        x, _ = load_wav(p, target_sr=sr)
        x = peak_normalize(x, 0.999)
        x = trim_silence_db(x, top_db=top_db)
        x = np.concatenate([x, np.zeros(pad_samples, np.float32)])
        save_wav(out / p.name, x, sr)
    print(f"processed {len(wavs)} wavs -> {out}")


def preprocess_text(transcript, out_dir, split_ratio: float = 0.95):
    """Orthographic transcript (lines '<name>|<arabic>' or 'name "arabic"')
    -> {train,test}_{arab,buckw,phon}.txt triplets
    (preprocess_text.py:25-56)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    entries = []
    for line in pathlib.Path(transcript).read_text(
            encoding="utf-8").splitlines():
        if not line.strip():
            continue
        if "|" in line:
            name, arab = line.split("|", 1)
        else:
            parts = line.split(None, 1)
            name, arab = parts[0].strip('"'), parts[1].strip().strip('"')
        arab = arab.strip()
        # shadda-ordering fixes are part of the phonetizer normalization
        buckw = text_frontend.arabic_to_buckwalter(arab)
        phon = text_frontend.process_utterance(buckw)
        entries.append((name, arab, buckw, phon))

    n_train = int(len(entries) * split_ratio)
    for split, chunk in (("train", entries[:n_train]),
                         ("test", entries[n_train:])):
        for kind, idx in (("arab", 1), ("buckw", 2), ("phon", 3)):
            lines = [f'"{e[0]}" "{e[idx]}"' for e in chunk]
            (out / f"{split}_{kind}.txt").write_text(
                "\n".join(lines), encoding="utf-8")
    print(f"wrote {len(entries)} entries ({n_train} train) -> {out}")


def extract_f0(wav_dir, out_path, sr: int = 22050, hop: int = 256):
    """Per-wav f0 via pYIN -> .npz dict + corpus mean/std
    (extract_f0.py:25-78)."""
    wavs = sorted(pathlib.Path(wav_dir).glob("**/*.wav"))
    f0_dict, mean, std = extract_f0_dict(wavs, sr, hop)
    np.savez(out_path, **f0_dict)
    print(f"extracted f0 for {len(wavs)} wavs -> {out_path}")
    print(f"f0_mean: {mean:.5f}\nf0_std: {std:.5f}")
    return mean, std


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("audio")
    pa.add_argument("--in-dir", required=True)
    pa.add_argument("--out-dir", required=True)
    pa.add_argument("--sr", type=int, default=22050)
    pa.add_argument("--top-db", type=float, default=23.0)

    pt = sub.add_parser("text")
    pt.add_argument("--transcript", required=True)
    pt.add_argument("--out-dir", default="data")

    pf = sub.add_parser("f0")
    pf.add_argument("--wav-dir", required=True)
    pf.add_argument("--out", default="data/pitch_dict.npz")

    args = parser.parse_args(argv)
    if args.cmd == "audio":
        preprocess_audio(args.in_dir, args.out_dir, args.sr, args.top_db)
    elif args.cmd == "text":
        preprocess_text(args.transcript, args.out_dir)
    else:
        extract_f0(args.wav_dir, args.out)


if __name__ == "__main__":
    main()
