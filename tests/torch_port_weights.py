"""Seeded weights of a narrow FastPitch, narrow HiFi-GANs, Tacotron2 and
Vocos for the port's CPU tests, written as reference `.pth` files that the
port and the JAX package both load (the JAX package through its own `.pth`
importer, which spares its eager flax init, some 35 s on the CPU)."""
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


# JAX's SMALL Tacotron2 (tests/test_tacotron_pipeline.py)
SMALL_TACOTRON2 = dict(
    n_symbols=40, symbol_embedding_dim=32, encoder_embedding_dim=32,
    num_speakers=1, decoder_rnn_dim=48, attention_rnn_dim=48,
    attention_hidden_dim=16, attention_location_n_filters=4,
    attention_location_kernel_size=7, prenet_dim=16,
    postnet_embedding_dim=32, postnet_n_convolutions=3, n_mels=80,
    decoder_max_step=96)


def tacotron2_state_dict(config, seed: int = 0,
                         gate_bias: float = -2.0) -> dict:
    """Seeded reference-layout Tacotron2 weights, drawn with numpy: weights
    N(0, 1/fan_in), biases N(0, 0.1), BatchNorm scale U(0.8, 1.2) and
    running statistics mean N(0, 0.1), var U(0.5, 1.5). The gate bias is
    set to `gate_bias` (-2.0 keeps the random gate shut, so a decode runs
    to its step cap)."""
    import numpy as np

    from tts_arabic_torch.models.tacotron2 import Tacotron2
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in Tacotron2(config).state_dict().items():
        shape = tuple(val.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0)
            continue
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif key.endswith("running_mean") or len(shape) == 1 and (
                "bias" in key):
            a = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:           # a BatchNorm scale
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        sd[key] = torch.tensor(a, dtype=torch.float32)
    sd["decoder.gate_layer.linear_layer.bias"].fill_(gate_bias)
    return sd


def write_tacotron2_weights(directory, config, seed: int = 0,
                            gate_bias: float = -2.0) -> str:
    """A reference Tacotron2 `.pth` ({'model', 'config'}) that the port
    and the JAX package both load."""
    import dataclasses
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    path = d / "tacotron2.pth"
    torch.save({"model": tacotron2_state_dict(config, seed, gate_bias),
                "config": dataclasses.asdict(config)}, path)
    return str(path)


# HiFi-GAN V1's kernel sizes, dilations and upsample rates on 128 initial
# channels: one stage (C = 64) that the int8 path claims at min_ch = 64,
# 3 blocks x 3 dilations x 2 convs = 18 sites (the 64-channel vocoder
# above claims none, which the JAX package refuses)
INT8_VOCODER = dict(NARROW_VOCODER, upsample_initial_channel=128)


def write_int8_vocoder(directory, seed: int = 1,
                       gain: float = 1.0) -> tuple:
    """A seeded INT8_VOCODER as a reference `.pth` -> (`.pth`, `.json`).
    `gain` scales conv_post: the seeded generator alone gives waves near
    4e-4."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    vocoder_json = d / "vocoder_int8.json"
    vocoder_json.write_text(json.dumps(INT8_VOCODER))
    generator = init_weights(
        Generator(HiFiGANConfig.from_json(vocoder_json)), seed)
    with torch.no_grad():
        generator.conv_post.weight.mul_(gain)
    path = d / "hifigan_int8.pth"
    torch.save({"generator": generator.state_dict()}, path)
    return str(path), str(vocoder_json)


def vocos_state_dict(module, seed: int = 0) -> dict:
    """Seeded reference-layout weights for a Vocos module of the port,
    drawn with numpy: weights N(0, 1/fan_in), biases N(0, 0.1), LayerNorm
    scales U(0.8, 1.2), layer-scale gammas U(0.05, 0.2); plus the
    reference's ISTFT window buffer, which carries no weights and which a
    loader skips."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sd = {}
    for key, val in module.state_dict().items():
        shape = tuple(val.shape)
        if key.endswith("gamma") or ".gamma." in key:
            a = rng.uniform(0.05, 0.2, shape)
        elif len(shape) == 1 and key.endswith("weight"):   # a LayerNorm
            a = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 1:
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        sd[key] = torch.tensor(a, dtype=torch.float32)
    sd["head.istft.window"] = torch.hann_window(1024)
    return sd


def write_vocos_weights(directory, seed: int = 0) -> str:
    """A seeded reference MelVocos `.pth` (CONFIG_22K's full widths) that
    the port and the JAX package both load."""
    from tts_arabic_torch.vocoder.vocos import CONFIG_22K, MelVocosModule
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    module = MelVocosModule(**{k: v for k, v in CONFIG_22K.items()
                               if k != "sample_rate"})
    path = d / "vocos.pth"
    torch.save(vocos_state_dict(module, seed), path)
    return str(path)
