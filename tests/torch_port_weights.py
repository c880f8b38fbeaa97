"""Seeded weights of a narrow FastPitch and a narrow HiFi-GAN for the port's
CPU tests, written as reference `.pth` files that the port and the JAX
package both load (the JAX package through its own `.pth` importer, which
spares its eager flax init, some 35 s on the CPU)."""
import json
import pathlib

import torch

from tts_arabic_torch.models.fastpitch import FastPitch, FastPitchConfig
from tts_arabic_torch.models.layers import init_weights
from tts_arabic_torch.vocoder.hifigan import Generator, HiFiGANConfig

SMALL_FASTPITCH = dict(d_model=64, enc_n_layers=2, dec_n_layers=2,
                       enc_filter_size=128, dec_filter_size=128,
                       dur_filter_size=32, pitch_filter_size=32,
                       energy_filter_size=32)
# HiFi-GAN V1's kernel sizes, dilations and upsample rates (so its
# receptive field and hop are the real ones) on 64 initial channels
NARROW_VOCODER = dict(resblock="1", upsample_rates=[8, 8, 2, 2],
                      upsample_kernel_sizes=[16, 16, 4, 4],
                      upsample_initial_channel=64,
                      resblock_kernel_sizes=[3, 7, 11],
                      resblock_dilation_sizes=[[1, 3, 5]] * 3)


def small_fastpitch(seed: int = 0, duration_bias: float = 2.0) -> FastPitch:
    """A seeded narrow FastPitch whose duration head is biased up (a
    zero-biased random head predicts about 0 frames a token)."""
    model = init_weights(FastPitch(FastPitchConfig(**SMALL_FASTPITCH)), seed)
    with torch.no_grad():
        model.duration_predictor.fc.bias.add_(duration_bias)
    return model


def write_weights(directory, seed: int = 0, duration_bias: float = 2.0):
    """-> (FastPitch `.pth`, HiFi-GAN `.pth`, HiFi-GAN config `.json`)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    model = small_fastpitch(seed, duration_bias)
    fastpitch = d / "fastpitch.pth"
    torch.save({"model": model.state_dict(),
                "config": model.config.to_reference_net_config()}, fastpitch)
    vocoder_json = d / "vocoder.json"
    vocoder_json.write_text(json.dumps(NARROW_VOCODER))
    generator = init_weights(
        Generator(HiFiGANConfig.from_json(vocoder_json)), seed + 1)
    vocoder = d / "hifigan.pth"
    torch.save({"generator": generator.state_dict()}, vocoder)
    return str(fastpitch), str(vocoder), str(vocoder_json)
