"""Quantitative evaluation CLI: oversmoothing metrics + MCD over a test set
(the port's counterpart of the JAX package's `apps/evaluate.py`).

    python -m tts_arabic_torch.apps.evaluate --labels data/test_phon.txt \
        --wav-dir <corpus wavs> --checkpoint <ckpt> --out metrics.json
    python -m tts_arabic_torch.apps.evaluate ... --cpu

Synthesizes each test utterance's mel from its corpus phoneme transcript
(FastPitch or `--model tacotron2`, on the CUDA card unless `--cpu` or
`--device cpu`), computes the ground-truth mels from the corpus audio,
and reports DTW-aligned oversmoothing deltas + MCD per utterance and in
aggregate, scored on the host. `--copy-synthesis` takes the ground-truth
mel as the prediction (no model): MCD and every aligned delta come out 0.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

from ..data.dataset import DEFAULT_LABEL_PATTERN, ArabDataset
from ..eval import mcd, oversmoothing_metrics_aligned
from ..eval.oversmoothing import compute_mel_oversmoothing_metrics


def _synthesize(args, ds, n: int) -> list:
    """The model's mel [80, T] of each of the first n utterances, from
    the dataset's token ids (so G2P differences cannot skew the
    comparison)."""
    device = "cpu" if args.cpu else args.device
    if args.model == "fastpitch":
        from ..infer import FastPitchTTS
        model = FastPitchTTS(args.checkpoint, arabic_in=False, device=device)
    else:
        from ..infer import Tacotron2TTS
        model = Tacotron2TTS(args.checkpoint, arabic_in=False, device=device)
    from ..text import ids_to_tokens
    mels_pred = []
    for k in range(0, n, args.batch_size):
        ids_list = [np.asarray(ds.data[i][0], np.int64)
                    for i in range(k, min(n, k + args.batch_size))]
        if args.model == "fastpitch":
            mel, mel_lens, inverse, _ = model._infer_batch_mel(
                ids_list, 1.0, 0, 1.0, 0.0)
            mel = mel.float().cpu().numpy()
            mel_lens = mel_lens.cpu().numpy()
            for i in inverse:
                mels_pred.append(mel[i, : mel_lens[i]].T)
        else:
            tokens_list = [ids_to_tokens(x) for x in ids_list]
            mel_post, mel_lens, _, _, inverse = model._infer_batch(
                tokens_list, 0)
            for i in inverse:
                mels_pred.append(mel_post[i, : mel_lens[i]].T)
    return mels_pred


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--labels", default="data/test_phon.txt")
    parser.add_argument("--wav-dir", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--model", choices=["fastpitch", "tacotron2"],
                        default="fastpitch")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--out", default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="the same as --device cpu")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card")
    parser.add_argument("--copy-synthesis", action="store_true",
                        help="use the ground-truth mel as the prediction "
                        "(no model): sanity-checks the metric plumbing - "
                        "MCD and every DTW-aligned delta must come out 0")
    args = parser.parse_args(argv)

    ds = ArabDataset(args.labels, args.wav_dir,
                     label_pattern=DEFAULT_LABEL_PATTERN)
    n = min(len(ds), args.limit or len(ds))
    if args.copy_synthesis:
        mels_pred = [ds._load_logmel(ds.data[i][1])[0] for i in range(n)]
    else:
        mels_pred = _synthesize(args, ds, n)

    per_utt = []
    for i in range(n):
        mel_ref = ds._load_logmel(ds.data[i][1])[0]
        mel_pred = mels_pred[i]
        row = {"utt": str(ds.data[i][1].name),
               "mcd": mcd(mel_pred, mel_ref)}
        row.update(oversmoothing_metrics_aligned(mel_pred, mel_ref))
        for k, v in compute_mel_oversmoothing_metrics(
                mel_pred, reduction="median").items():
            if np.isscalar(v):
                row[f"pred_{k}"] = float(v)
        per_utt.append(row)

    agg = {}
    for k in per_utt[0]:
        if k == "utt":
            continue
        vals = [r[k] for r in per_utt if np.isfinite(r[k])]
        agg[k] = float(np.mean(vals)) if vals else float("nan")
    report = {"n_utterances": n, "aggregate": agg, "per_utterance": per_utt}
    text = json.dumps(report, indent=1)
    if args.out:
        pathlib.Path(args.out).write_text(text)
        print(f"wrote {args.out}")
    print(json.dumps({"n": n, **{k: round(v, 4) for k, v in agg.items()}}))


if __name__ == "__main__":
    main()
