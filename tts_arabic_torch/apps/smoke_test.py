"""Single-sentence smoke test CLI (reference `test.py`; the port's
counterpart of the JAX package's `apps/smoke_test.py`).

    python -m tts_arabic_torch.apps.smoke_test --text "..." --out-dir out/
    python -m tts_arabic_torch.apps.smoke_test ... --cpu

Synthesizes one sentence (on the CUDA card unless `--cpu` or `--device
cpu`) and writes the wav, a mel PNG and an HTML page. The PNG needs
matplotlib: where it is not installed, no PNG is written and the output
line says so; the wav and the page are written all the same. Optional
playback through sounddevice where it is installed (test.py:91-96).
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from ..audio import save_wav
from .html_report import make_sample_entry, write_page

DEFAULT_TEXT = "اَلسَّلامُ عَلَيكُم يَا صَدِيقِي"


def _plot(mel, title: str, path: pathlib.Path) -> bool:
    """The mel's PNG at `path`; False when matplotlib is missing."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    from ..eval.plotting import plot_mel
    plot_mel(mel, title=title).savefig(path, dpi=120)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--text", default=DEFAULT_TEXT)
    parser.add_argument("--model", choices=["fastpitch", "tacotron2"],
                        default="fastpitch")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--vocoder-sd", default=None)
    parser.add_argument("--vocoder-config", default=None)
    parser.add_argument("--out-dir", default="samples/test")
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--denoise", type=float, default=0.005)
    parser.add_argument("--vowelizer", default=None)
    parser.add_argument("--buckwalter", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="the same as --device cpu")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card")
    parser.add_argument("--play", action="store_true")
    args = parser.parse_args(argv)

    kw = dict(vocoder_sd=args.vocoder_sd, vocoder_config=args.vocoder_config,
              vowelizer=args.vowelizer, arabic_in=not args.buckwalter,
              device="cpu" if args.cpu else args.device)
    if args.model == "fastpitch":
        from ..infer import FastPitch2Wave
        tts = FastPitch2Wave(args.checkpoint, **kw)
    else:
        from ..infer import Tacotron2Wave
        tts = Tacotron2Wave(args.checkpoint, **kw)

    wave, mel = tts.tts(args.text, speed=args.speed, denoise=args.denoise,
                        return_mel=True)
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_wav(out / "sample.wav", np.asarray(wave), tts.sample_rate)
    plotted = _plot(mel, args.text[:40], out / "mel.png")
    write_page(out / "index.html",
               [make_sample_entry(args.text, "sample.wav",
                                  label=args.model)],
               title="smoke test")
    dur = len(wave) / tts.sample_rate
    files = "sample.wav, mel.png, index.html" if plotted else (
        "sample.wav, index.html (no mel.png: matplotlib is not installed)")
    print(f"ok: {dur:.2f}s audio on {tts.device} -> {out}: {files}")

    if args.play:
        try:
            import sounddevice
            sounddevice.play(np.asarray(wave), tts.sample_rate,
                             blocking=True)
        except Exception as e:  # noqa: BLE001 - playback is optional
            print(f"(playback unavailable: {e})")


if __name__ == "__main__":
    main()
