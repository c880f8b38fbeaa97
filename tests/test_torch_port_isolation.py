"""The PyTorch port stands alone: it imports no JAX, no flax and nothing of
tts_arabic_tpu, and its entry points refuse to run quietly on the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

PORT = pathlib.Path(__file__).resolve().parent.parent / "tts_arabic_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tts_arabic_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tts_arabic_torch\n"
        "for m in pkgutil.walk_packages(tts_arabic_torch.__path__,\n"
        "                               'tts_arabic_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(list(pkgutil.walk_packages(tts_arabic_torch.__path__))))\n"
        "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PORT.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.strip().splitlines()
    assert int(n_modules) >= 6
    assert bad == "[]", bad


def test_module_walk_reaches_every_sub_package():
    import importlib
    import pkgutil

    import tts_arabic_torch
    names = {m.name for m in pkgutil.walk_packages(
        tts_arabic_torch.__path__, "tts_arabic_torch.")}
    for sub in ("align", "apps", "audio", "data", "diacritizers", "eval",
                "infer", "models", "ops", "parallel", "runtime", "text",
                "train", "vocoder"):
        assert f"tts_arabic_torch.{sub}" in names, sub
    for mod in ("align.mas", "align.prior", "apps.html_report",
                "apps.inference", "apps.server", "apps.train_fastpitch",
                "apps.train_tacotron", "apps.train_vocoder", "train.gan",
                "apps.download", "apps.evaluate", "apps.export_serving",
                "apps.export_torch", "apps.preprocess", "apps.smoke_test",
                "data.dataset", "data.f0", "diacritizers.models",
                "eval.alignment", "eval.dtw", "eval.flops",
                "eval.gate_control",
                "eval.oversmoothing", "eval.plotting", "infer.longform",
                "infer.tacotron_pipeline", "models.tacotron2", "ops.ctc",
                "ops.mas", "parallel.mesh", "parallel.sp", "parallel.tp",
                "runtime.checkpoint", "runtime.config",
                "runtime.logging", "runtime.profiling", "train.losses",
                "train.steps", "train.trainer", "train.vocoder",
                "vocoder.discriminators"):
        assert f"tts_arabic_torch.{mod}" in names, mod
        importlib.import_module(f"tts_arabic_torch.{mod}")


def test_gate_control_cache_stays_in_the_checkout(monkeypatch, tmp_path):
    """The calibration cache is the port's own: `build/gate_cache` in the
    checkout (git-ignored), or `$TTS_ARABIC_TORCH_GATE_CACHE`; the JAX
    package's variable does not move it."""
    from tts_arabic_torch.eval import gate_control
    monkeypatch.delenv("TTS_ARABIC_TORCH_GATE_CACHE", raising=False)
    monkeypatch.setenv("TTS_ARABIC_GATE_CACHE", str(tmp_path / "jax"))
    assert gate_control._cache_dir() == PORT.parent / "build" / "gate_cache"
    monkeypatch.setenv("TTS_ARABIC_TORCH_GATE_CACHE", str(tmp_path))
    assert gate_control._cache_dir() == tmp_path


def test_parallel_layer_and_dtw_loader_stay_inside_the_port():
    """`parallel/` and the DTW loader import no JAX and nothing of the JAX
    package (the walk above imports them in a fresh process; here their
    sources are read), and the DTW library is the port's own: built from
    `csrc/dtw.cc` into `build/`, with no path into the JAX package's
    `native/`."""
    from tts_arabic_torch.eval import dtw
    from tts_arabic_torch.ops import build
    assert dtw.using_native_kernel()
    lib = pathlib.Path(build.host_library("dtw")._name).resolve()
    assert lib.parent == (PORT.parent / "build").resolve(), lib
    assert lib.name.startswith("libdtw_")
    assert (PORT / "csrc" / "dtw.cc").is_file()
    for src in [PORT / "eval" / "dtw.py", PORT / "ops" / "build.py",
                *sorted((PORT / "parallel").glob("*.py"))]:
        text = src.read_text()
        assert "native/" not in text and "libdtw.so" not in text, src
        for node in ast.walk(ast.parse(text, str(src))):
            if isinstance(node, ast.Import):
                assert not any(_forbidden(a.name) for a in node.names), src
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                assert not _forbidden(node.module or ""), src


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert offenders == []


@pytest.mark.parametrize("entry", ["FastPitch2Wave", "FastPitchTTS",
                                   "Shakkala", "Shakkelha", "Tacotron2Wave",
                                   "Tacotron2TTS"])
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    from tts_arabic_torch import diacritizers, infer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = getattr(diacritizers if entry.startswith("Shakk") else infer,
                  entry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(device="cuda")


@pytest.mark.parametrize("cli,flags", [
    ("train_fastpitch", []), ("train_fastpitch", ["--adv"]),
    ("train_tacotron", []), ("train_tacotron", ["--adv"]),
    ("train_vocoder", [])])
def test_training_cli_raises_without_cuda(monkeypatch, cli, flags):
    """`--device` defaults to cuda; without a card the CLI raises before it
    reads its config or its corpus."""
    import importlib
    main = importlib.import_module(f"tts_arabic_torch.apps.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--config", "no/such/config.yaml"] + flags)


@pytest.mark.parametrize("entry", ["train_step", "eval_step", "Trainer",
                                   "tacotron_train_step",
                                   "tacotron_eval_step", "vocoder_train_step",
                                   "vocoder_eval_step", "vocoder_state"])
def test_training_entry_points_raise_without_cuda(entry, monkeypatch,
                                                  tmp_path):
    from tts_arabic_torch.train import steps, vocoder
    from tts_arabic_torch.train.trainer import Trainer
    from tts_arabic_torch.vocoder import discriminators as disc
    from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {"train_step": steps.make_fastpitch_train_step,
            "vocoder_train_step": vocoder.make_hifigan_train_step,
            "vocoder_eval_step": vocoder.make_hifigan_eval_step,
            "vocoder_state": lambda **kw: vocoder.init_vocoder_state(
                Generator(HiFiGANConfig(upsample_initial_channel=32)),
                disc.MultiPeriodDiscriminator((2,), 0.125),
                disc.MultiScaleDiscriminator(1, 0.125), **kw),
            "eval_step": steps.make_fastpitch_eval_step,
            "tacotron_train_step": steps.make_tacotron_train_step,
            "tacotron_eval_step": steps.make_tacotron_eval_step,
            "Trainer": lambda **kw: Trainer(
                None, None, log_dir=tmp_path / "logs",
                checkpoint_dir=tmp_path / "ckpt", **kw)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(device="cuda")
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("cli,argv", [
    ("export_serving", ["--out", "{tmp}/bundle"]),
    ("export_serving", ["--out", "{tmp}/bundle", "--model", "tacotron2"]),
    ("evaluate", ["--labels", "{tmp}/labels.txt", "--wav-dir", "{tmp}"]),
    ("smoke_test", ["--out-dir", "{tmp}/smoke"]),
    ("smoke_test", ["--out-dir", "{tmp}/smoke", "--model", "tacotron2"])])
def test_offline_cli_raises_without_cuda(monkeypatch, tmp_path, cli, argv):
    """The bundle exporter, evaluate (when it synthesizes) and the smoke
    test run on the card unless told otherwise, and raise without one."""
    import importlib
    main = importlib.import_module(f"tts_arabic_torch.apps.{cli}").main
    (tmp_path / "labels.txt").write_text("")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([a.format(tmp=tmp_path) for a in argv])
    assert not (tmp_path / "bundle").exists()


def test_bundles_and_download_verify_need_the_card(monkeypatch, tmp_path):
    """A bundle exported for the card does not load without one, and
    `download --verify` reports the missing card as its artifact's
    failure."""
    import json

    from tts_arabic_torch.apps import download, export_serving
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "manifest.json").write_text(json.dumps(
        {"format": 1, "model": "fastpitch2wave", "device": "cuda"}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_serving.ServingBundle(tmp_path)
    from torch_port_weights import write_weights
    _, voc, voc_cfg = write_weights(tmp_path / "w")
    art = tmp_path / download.FILES["hifigan-asc.pth"]["path"]
    art.parent.mkdir(parents=True)
    art.write_bytes(pathlib.Path(voc).read_bytes())
    (art.parent / "config.json").write_text(pathlib.Path(voc_cfg).read_text())
    lines = []
    assert download.run_verify(tmp_path, ["hifigan-asc.pth"], fetcher=None,
                               out=lines.append) == 1
    assert "FAIL" in lines[-1] and "no CUDA device" in lines[-1]
    assert download.run_verify(tmp_path, ["hifigan-asc.pth"], fetcher=None,
                               out=lines.append, device="cpu") == 0
    assert "OK" in lines[-1] and "wave 4096 samples" in lines[-1]


def test_resblock_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises, never falls back."""
    from tts_arabic_torch.ops import resblock1
    C, k = 32, 3
    x = torch.zeros((1, 20, C), device="meta")
    w = torch.zeros((3, C, C, k), device="meta")
    b = torch.zeros((3, C), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resblock1(x, w, b, w, b, k, (1, 3, 5))
