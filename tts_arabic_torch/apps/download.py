"""Pretrained-artifact downloader and verifier (reference
`download_files.py`; the port's counterpart of the JAX package's
`apps/download.py`).

    python -m tts_arabic_torch.apps.download [--all | names...]
    python -m tts_arabic_torch.apps.download --verify [--cpu]

Fetches the reference project's released checkpoints (Google Drive URLs
from the reference manifest) into `pretrained/` with gdown, where it is
installed; the port's pipelines load those `.pth` files as they are.

`--verify`, for each artifact: fetches it if it is missing and a fetcher
is available, loads it through the port's loader and runs one sentence
or forward pass through it (on the CUDA card unless `--cpu` or
`--device cpu`), and reports OK or FAIL with the file's sha256 prefix.
With no fetcher (gdown is not installed) a missing file is skipped and
the exit code stays 0; a present file that fails exits 1.
"""
from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys

# Artifact manifest mirroring the reference downloader's targets
# (names, relative paths, and Drive URLs must match the published set).
FILES = {
    "tacotron2_ar_mse.pth": {
        "path": "pretrained/tacotron2_ar_mse.pth",
        "url": "https://drive.google.com/file/d/"
               "1GCu-ZAcfJuT5qfzlKItcNqtuVNa7CNy9/view?usp=sharing",
        "kind": "tacotron2 (MSE)", "verify": "tacotron2"},
    "tacotron2_ar_adv.pth": {
        "path": "pretrained/tacotron2_ar_adv.pth",
        "url": "https://drive.google.com/file/d/"
               "1FusCFZIXSVCQ9Q6PLb91GIkEnhn_zWRS/view?usp=sharing",
        "kind": "tacotron2 (adversarial)", "verify": "tacotron2"},
    "fastpitch_ar_mse.pth": {
        "path": "pretrained/fastpitch_ar_mse.pth",
        "url": "https://drive.google.com/file/d/"
               "1sliRc62wjPTnPWBVQ95NDUgnCSH5E8M0/view?usp=sharing",
        "kind": "fastpitch (MSE)", "verify": "fastpitch"},
    "fastpitch_ar_adv.pth": {
        "path": "pretrained/fastpitch_ar_adv.pth",
        "url": "https://drive.google.com/file/d/"
               "1-vZOhi9To_78-yRslC6sFLJBUjwgJT-D/view?usp=sharing",
        "kind": "fastpitch (adversarial)", "verify": "fastpitch"},
    "fastpitch_ar_ms.pth": {
        "path": "pretrained/fastpitch_ar_ms.pth",
        "url": "https://drive.google.com/file/d/"
               "18IYUSRXvLErVjaDORj_TKzUxs90l61Ja/view?usp=sharing",
        "kind": "fastpitch (multispeaker)", "verify": "fastpitch_ms"},
    "hifigan-asc.pth": {
        "path": "pretrained/hifigan-asc-v1/hifigan-asc.pth",
        "url": "https://drive.google.com/file/d/"
               "1zSYYnJFS-gQox-IeI71hVY-fdPysxuFK/view?usp=sharing",
        "kind": "HiFi-GAN vocoder", "verify": "hifigan"},
    "shakkelha_rnn_3_big_20.pth": {
        "path": "pretrained/diacritizers/shakkelha_rnn_3_big_20.pth",
        "url": "https://drive.google.com/file/d/"
               "1CbDjbuBr-798x88vjLGtMPSB2Y1KwD68/view?usp=sharing",
        "kind": "Shakkelha diacritizer", "verify": "shakkelha"},
    "shakkala_second_model6.pth": {
        "path": "pretrained/diacritizers/shakkala_second_model6.pth",
        "url": "https://drive.google.com/file/d/"
               "1hgMGqXLTc58Gq_bN7WpuBWscBxX-rXXd/view?usp=sharing",
        "kind": "Shakkala diacritizer", "verify": "shakkala"},
}

TEST_PHONEMES = "b a m a k a"  # one-sentence smoke input (Buckwalter phons)


def default_fetcher():
    """gdown-backed fetcher, or None when gdown isn't installed."""
    try:
        import gdown
    except ImportError:
        return None

    def fetch(url: str, dest: pathlib.Path):
        dest.parent.mkdir(parents=True, exist_ok=True)
        gdown.download(url=url, output=str(dest), fuzzy=True, quiet=True)

    return fetch


def sha256_prefix(path: pathlib.Path, n=12) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()[:n]


def _check_hifigan(path: pathlib.Path, device) -> str:
    import numpy as np
    import torch

    from ..models.convert import (fold_weight_norm, load_reference_pth,
                                  to_tensors)
    from ..runtime.device import resolve_device
    from ..vocoder.hifigan import Generator, HiFiGANConfig
    sib = path.parent / "config.json"
    cfg = HiFiGANConfig.from_json(sib) if sib.is_file() else HiFiGANConfig()
    gen = Generator(cfg)
    sd, _ = load_reference_pth(path)
    gen.load_state_dict(to_tensors(fold_weight_norm(sd)), strict=True)
    dev = resolve_device(device)
    gen.to(dev).eval()
    mel = torch.full((1, 16, cfg.num_mels), float(np.log(1e-5)), device=dev)
    with torch.no_grad():
        wave = gen(mel)
    assert torch.isfinite(wave).all()
    return f"wave {wave.shape[1]} samples"


def verify_artifact(name: str, path: pathlib.Path,
                    device=None) -> tuple[bool, str]:
    """Load the artifact through the port's loader and run one synthesis
    or forward pass on `device` (None: the card). Returns (ok, detail)."""
    import numpy as np

    kind = FILES[name]["verify"]
    try:
        if kind in ("fastpitch", "fastpitch_ms"):
            from ..infer import FastPitchTTS
            tts = FastPitchTTS(checkpoint=path, arabic_in=False,
                               device=device)
            sid = tts.config.n_speakers - 1 if kind == "fastpitch_ms" else 0
            mel = tts.ttmel(TEST_PHONEMES, speaker_id=sid)
            assert mel.shape[0] == 80 and np.isfinite(mel).all()
            detail = f"mel {mel.shape[0]}x{mel.shape[1]}"
        elif kind == "tacotron2":
            from ..infer import Tacotron2TTS
            tts = Tacotron2TTS(checkpoint=path, arabic_in=False,
                               decoder_max_step=128, device=device)
            mel = tts.ttmel(TEST_PHONEMES, postprocess_mel=False)
            assert mel.shape[0] == 80 and np.isfinite(mel).all()
            detail = f"mel {mel.shape[0]}x{mel.shape[1]}"
        elif kind == "hifigan":
            detail = _check_hifigan(path, device)
        elif kind in ("shakkala", "shakkelha"):
            from ..diacritizers import Shakkala, Shakkelha
            cls = Shakkala if kind == "shakkala" else Shakkelha
            out = cls(sd_path=str(path), device=device).predict("كتب")
            assert isinstance(out, str) and len(out) >= 3
            detail = f"diacritized {len(out)} chars"
        else:  # pragma: no cover - manifest and dispatch are in sync
            return False, f"no verifier for kind {kind!r}"
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        return False, f"{type(e).__name__}: {e}"
    return True, f"{detail}, sha256 {sha256_prefix(path)}"


_USE_DEFAULT = object()


def run_verify(root: pathlib.Path, names, fetcher=_USE_DEFAULT,
               out=print, device=None) -> int:
    """Fetch-if-possible then verify each artifact; returns exit code.
    `fetcher=None` forces offline mode (tests); the default resolves to
    gdown when installed."""
    if fetcher is _USE_DEFAULT:
        fetcher = default_fetcher()
    failures = 0
    out(f"{'name':32s} {'status':8s} detail")
    for name in names:
        info = FILES[name]
        path = root / info["path"]
        if not path.is_file() and fetcher is not None:
            try:
                fetcher(info["url"], path)
            except Exception as e:  # noqa: BLE001
                out(f"{name:32s} {'FAIL':8s} fetch error: {e}")
                failures += 1
                continue
        if not path.is_file():
            out(f"{name:32s} {'skipped':8s} not present, no fetcher "
                "(offline)")
            continue
        ok, detail = verify_artifact(name, path, device)
        out(f"{name:32s} {'OK' if ok else 'FAIL':8s} {detail}")
        failures += 0 if ok else 1
    return 1 if failures else 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("names", nargs="*", help="subset of files to fetch")
    parser.add_argument("--dest", default=".",
                        help="project root (artifacts land under "
                             "<dest>/pretrained/)")
    parser.add_argument("--verify", action="store_true",
                        help="fetch if possible, then load each artifact "
                             "through the port's loader and synthesize one "
                             "sentence; reports OK/hash per artifact")
    parser.add_argument("--cpu", action="store_true",
                        help="verify on the CPU (the same as --device cpu)")
    parser.add_argument("--device", default=None,
                        help="torch device for --verify; default the card")
    args = parser.parse_args(argv)

    targets = args.names or list(FILES)
    unknown = [n for n in targets if n not in FILES]
    if unknown:
        print(f"unknown artifact names: {unknown}", file=sys.stderr)
        return 2
    root = pathlib.Path(args.dest)

    if args.verify:
        return run_verify(root, targets,
                          device="cpu" if args.cpu else args.device)

    fetcher = default_fetcher()
    print(f"{'name':32s} {'status':10s} kind")
    for name in targets:
        info = FILES[name]
        path = root / info["path"]
        if path.is_file():
            status = "present"
        elif fetcher is not None:
            try:
                fetcher(info["url"], path)
                status = "fetched" if path.is_file() else "fetch-failed"
            except Exception:  # noqa: BLE001
                status = "fetch-failed"
        else:
            status = "missing"
        print(f"{name:32s} {status:10s} {info['kind']}")
    if fetcher is None:
        print("\ngdown is not installed in this environment; place the "
              "reference project's released checkpoints under pretrained/ "
              "manually - the loaders read them directly. Run with "
              "--verify once they are in place.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
