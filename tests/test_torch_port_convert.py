"""Weight carry-over: the port's `models/convert.py` emits the same
reference state dict as the JAX package's exporter, and a `.pth` written
with torch.save loads into the port's modules with strict=True."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_arabic_torch.models import convert
from tts_arabic_torch.models.fastpitch import (FastPitch as PortFastPitch,
                                               FastPitchConfig as PortCfg)
from tts_arabic_torch.vocoder.hifigan import (Generator as PortGenerator,
                                              HiFiGANConfig as PortHCfg)
from tts_arabic_tpu.models import torch_export
from tts_arabic_tpu.models.fastpitch import FastPitch, FastPitchConfig
from tts_arabic_tpu.vocoder.hifigan import Generator, HiFiGANConfig

SMALL = dict(d_model=64, enc_n_layers=2, dec_n_layers=2, enc_filter_size=128,
             dec_filter_size=128, dur_filter_size=32, pitch_filter_size=32,
             energy_filter_size=32)
SMALL_HIFI = dict(upsample_initial_channel=32)


@pytest.fixture(scope="module")
def fastpitch_vars():
    # init through infer and the aligner, so every parameter exists (a
    # trained checkpoint has the aligner's too)
    cfg = FastPitchConfig(**SMALL)
    tokens = jnp.ones((1, 8), jnp.int32)
    mel = jnp.zeros((1, 16, cfg.n_mel_channels))
    init = jax.jit(lambda key, t, x: FastPitch(cfg).init(
        key, t, x, method=lambda m, t, x: (m.infer(t, max_frames=16),
                                           m.align_attention(t, x, None))))
    return cfg, init(jax.random.PRNGKey(0), tokens, mel)


@pytest.fixture(scope="module")
def hifigan_vars():
    cfg = HiFiGANConfig(**SMALL_HIFI)
    mel = jnp.zeros((1, 8, cfg.num_mels))
    return cfg, jax.jit(Generator(cfg).init)(jax.random.PRNGKey(1), mel)


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), err_msg=key)


def test_fastpitch_state_dict_equals_exporter(fastpitch_vars):
    cfg, v = fastpitch_vars
    _assert_same(convert.fastpitch_params_to_torch(v, cfg),
                 torch_export.fastpitch_params_to_torch(v, cfg))


def test_hifigan_state_dict_equals_exporter(hifigan_vars):
    cfg, v = hifigan_vars
    _assert_same(convert.hifigan_params_to_torch(v, cfg),
                 torch_export.hifigan_params_to_torch(v, cfg))


def test_fold_weight_norm_both_layouts(hifigan_vars):
    cfg, v = hifigan_vars
    legacy = convert.fold_weight_norm(
        torch_export.hifigan_params_to_torch(v, cfg, layout="legacy"))
    modern = convert.fold_weight_norm(torch_export.hifigan_params_to_torch(
        v, cfg, layout="parametrizations"))
    assert sorted(legacy) == sorted(modern)
    assert not any(k.endswith(("weight_g", "weight_v")) for k in legacy)
    for key in legacy:
        np.testing.assert_allclose(modern[key], legacy[key], rtol=1e-6)
    # folding recovers the flax kernel (conv [k, in, out] -> [out, in, k])
    kern = np.asarray(v["params"]["res_1_2"]["conv2_1"]["kernel"])
    np.testing.assert_allclose(legacy["resblocks.5.convs2.1.weight"],
                               kern.transpose(2, 1, 0), rtol=1e-5, atol=1e-7)


def test_pth_round_trip_loads_strict(fastpitch_vars, hifigan_vars, tmp_path):
    cfg, v = fastpitch_vars
    fp_path = torch_export.save_reference_checkpoint(
        tmp_path / "fastpitch.pth", convert.fastpitch_params_to_torch(v, cfg),
        config=cfg.to_reference_net_config(), symbols=["_", "a"])
    sd, extras = convert.load_reference_pth(fp_path)
    port_cfg = PortCfg.from_reference_net_config(extras["config"])
    assert port_cfg == PortCfg(**SMALL)
    assert extras["symbols"] == ["_", "a"]
    model = PortFastPitch(port_cfg)
    model.load_state_dict(convert.to_tensors(sd), strict=True)
    np.testing.assert_array_equal(
        model.encoder.layers[1].pos_ff.CoreNet[2].weight.detach().numpy(),
        np.asarray(v["params"]["encoder"]["layer_1"]["ff"]["conv2"]
                   ["kernel"]).transpose(2, 1, 0))

    hcfg, hv = hifigan_vars
    voc_path = torch_export.save_reference_checkpoint(
        tmp_path / "hifigan.pth", convert.hifigan_params_to_torch(hv, hcfg),
        key="generator")
    sd, _ = convert.load_reference_pth(voc_path)
    gen = PortGenerator(PortHCfg(**SMALL_HIFI))
    gen.load_state_dict(convert.to_tensors(convert.fold_weight_norm(sd)),
                        strict=True)
    up = np.asarray(hv["params"]["up_2"]["kernel"])  # [k, in, out], flipped
    np.testing.assert_allclose(gen.ups[2].weight.detach().numpy(),
                               up[::-1].transpose(1, 2, 0), rtol=1e-5,
                               atol=1e-8)
    assert isinstance(gen.resblocks[0].convs1[0].weight, torch.nn.Parameter)
