"""Batched synthesis CLI (reference `inference.py`; the port's counterpart
of the JAX package's `apps/inference.py`).

    python -m tts_arabic_torch.apps.inference --list data/infer_text.txt \
        --buckwalter --checkpoint <states.ckpt or .pth> --out-dir samples/
    python -m tts_arabic_torch.apps.inference ... --device cpu

Synthesizes every line of the list file with FastPitch (bf16 decoder and
vocoder, the `--bf16` default) or `--model tacotron2` (f32 throughout, as
the JAX CLI builds it) and HiFi-GAN, and writes wavs and an HTML listening
page. The flags are the JAX CLI's, plus `--device`: it runs on the CUDA
card unless `--device cpu` (or `--cpu`) is given, and raises when there is
no card. `--quantize int8` serves either model with the static-calibrated
int8 MRF vocoder stages (and FastPitch's decoder FFN), calibrated when the
pipeline is built.
"""
from __future__ import annotations

import argparse
import pathlib
import re

import numpy as np
import torch

from ..audio import save_wav
from .html_report import make_sample_entry, write_page

_LABEL = re.compile(r'"[^"]+"\s+"(?P<text>[^"]+)"')


def read_lines(path):
    out = []
    for line in pathlib.Path(path).read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        m = _LABEL.match(line)
        out.append(m.group("text") if m else line.strip())
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--list", default="data/infer_text.txt")
    parser.add_argument("--model", choices=["fastpitch", "tacotron2"],
                        default="fastpitch")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--vocoder-sd", default=None)
    parser.add_argument("--vocoder-config", default=None)
    parser.add_argument("--out-dir", default="samples")
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--denoise", type=float, default=0.005)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--speaker-id", type=int, default=0)
    parser.add_argument("--vowelizer", default=None)
    parser.add_argument("--buckwalter", action="store_true",
                        help="input lines are Buckwalter, not Arabic script")
    parser.add_argument("--cpu", action="store_true",
                        help="the same as --device cpu")
    parser.add_argument("--bf16", action="store_true", default=True)
    parser.add_argument("--quantize", choices=["int8"], default=None,
                        help="int8 MRF vocoder serving path")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card")
    args = parser.parse_args(argv)

    kwargs = dict(vocoder_sd=args.vocoder_sd,
                  vocoder_config=args.vocoder_config,
                  vowelizer=args.vowelizer, arabic_in=not args.buckwalter,
                  quantize=args.quantize,
                  device="cpu" if args.cpu else args.device)
    if args.model == "fastpitch":
        from ..infer import FastPitch2Wave
        tts = FastPitch2Wave(
            args.checkpoint,
            compute_dtype=torch.bfloat16 if args.bf16 else None, **kwargs)
    else:
        from ..infer import Tacotron2Wave
        tts = Tacotron2Wave(args.checkpoint, **kwargs)

    lines = read_lines(args.list)
    print(f"synthesizing {len(lines)} utterances with {args.model} on "
          f"{tts.device}...")
    waves = tts.tts(lines, speed=args.speed, denoise=args.denoise,
                    speaker_id=args.speaker_id, batch_size=args.batch_size)

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = []
    total_sec = 0.0
    for i, (text, wave) in enumerate(zip(lines, waves)):
        name = f"wave_{i:04d}.wav"
        save_wav(out_dir / name, np.asarray(wave), tts.sample_rate)
        total_sec += len(wave) / tts.sample_rate
        entries.append(make_sample_entry(text, name, label=f"#{i}"))
    page = write_page(out_dir / "index.html", entries,
                      title=f"{args.model} samples")
    print(f"wrote {len(waves)} wavs ({total_sec:.1f}s audio) + {page}")
    return page


if __name__ == "__main__":
    main()
