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
                "infer", "models", "ops", "runtime", "text", "train",
                "vocoder"):
        assert f"tts_arabic_torch.{sub}" in names, sub
    for mod in ("align.mas", "align.prior", "apps.html_report",
                "apps.inference", "apps.server", "apps.train_fastpitch",
                "apps.train_tacotron", "apps.train_vocoder", "train.gan",
                "data.dataset", "data.f0", "diacritizers.models",
                "eval.alignment", "infer.longform", "infer.tacotron_pipeline",
                "models.tacotron2", "ops.ctc", "ops.mas",
                "runtime.checkpoint", "runtime.config", "runtime.logging",
                "train.losses", "train.steps", "train.trainer",
                "train.vocoder", "vocoder.discriminators"):
        assert f"tts_arabic_torch.{mod}" in names, mod
        importlib.import_module(f"tts_arabic_torch.{mod}")


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
