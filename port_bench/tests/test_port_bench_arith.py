"""The benchmark's frozen arithmetic held equal to the program's current
functions, at the cells' shapes: the FLOP counts (the port's
`eval/flops.py`, `vocoder/hifigan.py`) and the ResBlock1 bound
(`chip_smoke.py`'s `bound()`)."""
import importlib.util
import json

import pytest
import torch

from port_bench import harness, yardstick

CONFIG = json.loads((harness.HERE / "configs" / "fastpitch-hifigan-v1.json")
                    .read_text())


def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_bench", harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_tokens,n_frames", [(35, 230), (120, 780),
                                               (289, 1880)])
def test_fastpitch_flops(n_tokens, n_frames):
    from tts_arabic_torch.eval import flops
    from tts_arabic_torch.models.fastpitch import FastPitchConfig
    net = CONFIG["fastpitch"]
    cfg = FastPitchConfig.from_reference_net_config(net)
    assert (yardstick.fastpitch_encode_flops(net, n_tokens)
            == flops.fastpitch_encode_flops(cfg, n_tokens))
    assert (yardstick.fastpitch_decode_flops(net, n_tokens, n_frames)
            == flops.fastpitch_decode_flops(cfg, n_tokens, n_frames))


def test_generator_flops():
    from tts_arabic_torch.eval import flops
    from tts_arabic_torch.vocoder.hifigan import HiFiGANConfig
    h = CONFIG["hifigan"]
    cfg = HiFiGANConfig(**{k: tuple(map(tuple, v)) if k.endswith(
        "dilation_sizes") else tuple(v) if isinstance(v, list) else v
        for k, v in h.items()})
    assert cfg == HiFiGANConfig()
    for frames in (160, 768, 2048):
        assert (frames * yardstick.generator_flops_per_frame(h)
                == flops.hifigan_flops(frames, cfg))


@pytest.mark.parametrize("C,k,T,batch", [(256, 3, 6144, 16),
                                         (32, 11, 393216, 16),
                                         (128, 7, 10240, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resblock_bound(C, k, T, batch, dtype):
    got = yardstick.resblock_bound(C, k, T, dtype, batch)
    want = smoke().bound(C, k, T, getattr(torch, dtype), batch)
    assert got == pytest.approx(want, rel=1e-12)
