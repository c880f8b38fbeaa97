"""Weight carry-over: flax-layout parameter trees (nested dicts of numpy
arrays) -> the reference PyTorch state-dict layout the port's modules use,
and reference `.pth` checkpoints -> the port's state dicts.

Layout conventions (the reference's, as the JAX package's exporter emits
them):

- Dense kernel [in, out]    -> Linear weight [out, in]
- Conv kernel [k, in, out]  -> Conv1d weight [out, in, k]
- transposed-conv kernel [k, in, out], flipped along k (the JAX package's
  op-ready form) -> ConvTranspose1d weight [in, out, k]
- HiFi-GAN convs are emitted in the reference's weight-norm form
  (`weight_g`/`weight_v`, as the published artifact stores them) and
  folded back into plain weights at load by `fold_weight_norm`.

Pure numpy: no jax or flax is needed to read a tree of arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a) -> np.ndarray:
    return np.asarray(a)


def _dense_t(sd, prefix, p, bias=True):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if bias and "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _conv1d_t(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        _np(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _ln_t(sd, prefix, p):
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _fft_stack_t(sd, prefix, stack):
    for name, layer in stack.items():
        if name == "word_emb":
            sd[f"{prefix}.word_emb.weight"] = _np(layer["embedding"])
            continue
        p = f"{prefix}.layers.{name.split('_')[1]}"
        _dense_t(sd, f"{p}.dec_attn.qkv_net", layer["attn"]["qkv"])
        _dense_t(sd, f"{p}.dec_attn.o_net", layer["attn"]["o"], bias=False)
        _ln_t(sd, f"{p}.dec_attn.layer_norm", layer["attn"]["ln"])
        _conv1d_t(sd, f"{p}.pos_ff.CoreNet.0", layer["ff"]["conv1"])
        _conv1d_t(sd, f"{p}.pos_ff.CoreNet.2", layer["ff"]["conv2"])
        _ln_t(sd, f"{p}.pos_ff.layer_norm", layer["ff"]["ln"])


def _predictor_t(sd, prefix, pred):
    for name, layer in pred.items():
        if name == "fc":
            _dense_t(sd, f"{prefix}.fc", layer)
            continue
        i = name.split("_")[1]
        _conv1d_t(sd, f"{prefix}.layers.{i}.conv", layer["conv"])
        _ln_t(sd, f"{prefix}.layers.{i}.norm", layer["ln"])


def fastpitch_params_to_torch(variables: dict, config) -> dict:
    """flax FastPitch variables -> reference FastPitch state dict (flat
    {key: ndarray})."""
    params = variables["params"] if "params" in variables else variables
    sd: dict = {}
    _fft_stack_t(sd, "encoder", params["encoder"])
    _fft_stack_t(sd, "decoder", params["decoder"])
    # the reference's PositionalEmbedding buffer, deterministic in d_model
    for stack in ("encoder", "decoder"):
        d = config.d_model
        sd[f"{stack}.pos_emb.inv_freq"] = (
            1.0 / (10000.0 ** (np.arange(0.0, d, 2.0) / d))
        ).astype(np.float32)
    _predictor_t(sd, "duration_predictor", params["duration_predictor"])
    _predictor_t(sd, "pitch_predictor", params["pitch_predictor"])
    _conv1d_t(sd, "pitch_emb", params["pitch_emb"])
    _dense_t(sd, "proj", params["proj"])
    att = params["attention"]
    _conv1d_t(sd, "attention.key_proj.0.conv", att["key_conv1"])
    _conv1d_t(sd, "attention.key_proj.2.conv", att["key_conv2"])
    _conv1d_t(sd, "attention.query_proj.0.conv", att["query_conv1"])
    _conv1d_t(sd, "attention.query_proj.2.conv", att["query_conv2"])
    _conv1d_t(sd, "attention.query_proj.4.conv", att["query_conv3"])
    # the unused Conv2d the reference instantiates (attention.py:96)
    sd["attention.attn_proj.weight"] = np.zeros(
        (1, config.attn_channels, 1, 1), np.float32)
    sd["attention.attn_proj.bias"] = np.zeros((1,), np.float32)
    sd["pitch_mean"] = _np(params.get(
        "pitch_mean", np.zeros(1, np.float32))).reshape(1)
    sd["pitch_std"] = _np(params.get(
        "pitch_std", np.zeros(1, np.float32))).reshape(1)
    if config.energy_conditioning:
        _predictor_t(sd, "energy_predictor", params["energy_predictor"])
        _conv1d_t(sd, "energy_emb", params["energy_emb"])
    if "speaker_emb" in params:
        sd["speaker_emb.weight"] = _np(params["speaker_emb"]["embedding"])
    return sd


def _weight_norm_split(sd, prefix, weight):
    """w -> the legacy weight-norm pair v = w, g = ||w|| over all but dim 0
    (folds back to w exactly)."""
    w = np.ascontiguousarray(weight)
    g = np.sqrt((w.reshape(w.shape[0], -1) ** 2).sum(1))
    sd[f"{prefix}.weight_g"] = g.reshape(-1, *[1] * (w.ndim - 1))
    sd[f"{prefix}.weight_v"] = w


def hifigan_params_to_torch(variables: dict, config) -> dict:
    """flax HiFi-GAN Generator params -> reference weight-normed state
    dict."""
    params = variables["params"] if "params" in variables else variables
    sd: dict = {}

    def conv(prefix, p):
        _weight_norm_split(sd, prefix, _np(p["kernel"]).transpose(2, 1, 0))
        sd[f"{prefix}.bias"] = _np(p["bias"])

    conv("conv_pre", params["conv_pre"])
    conv("conv_post", params["conv_post"])
    n_kernels = len(config.resblock_kernel_sizes)
    for i in range(len(config.upsample_rates)):
        k = _np(params[f"up_{i}"]["kernel"])            # [k, in, out], flipped
        _weight_norm_split(sd, f"ups.{i}", k[::-1].transpose(1, 2, 0))
        sd[f"ups.{i}.bias"] = _np(params[f"up_{i}"]["bias"])
        for j in range(n_kernels):
            ridx = i * n_kernels + j
            block = params[f"res_{i}_{j}"]
            for d in range(len(config.resblock_dilation_sizes[j])):
                if config.resblock == "1":
                    conv(f"resblocks.{ridx}.convs1.{d}", block[f"conv1_{d}"])
                    conv(f"resblocks.{ridx}.convs2.{d}", block[f"conv2_{d}"])
                else:  # reference ResBlock2 names its one conv list `convs`
                    conv(f"resblocks.{ridx}.convs.{d}", block[f"conv1_{d}"])
    return sd


def _bilstm_t(sd, prefix, p):
    """One bidirectional layer ({'fwd', 'bwd'} of wi [C, 4H], wh [H, 4H],
    bi, bh) -> torch `nn.LSTM` keys, `_reverse` for the backward
    direction."""
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        q = p[direction]
        sd[f"{prefix}.weight_ih_l0{suffix}"] = np.ascontiguousarray(
            _np(q["wi"]).T)
        sd[f"{prefix}.weight_hh_l0{suffix}"] = np.ascontiguousarray(
            _np(q["wh"]).T)
        sd[f"{prefix}.bias_ih_l0{suffix}"] = _np(q["bi"])
        sd[f"{prefix}.bias_hh_l0{suffix}"] = _np(q["bh"])


def _lstm_cell_t(sd, prefix, p):
    """One LSTM cell (wi [in, 4H], wh [H, 4H], bi, bh) -> `nn.LSTMCell`
    keys."""
    sd[f"{prefix}.weight_ih"] = np.ascontiguousarray(_np(p["wi"]).T)
    sd[f"{prefix}.weight_hh"] = np.ascontiguousarray(_np(p["wh"]).T)
    sd[f"{prefix}.bias_ih"] = _np(p["bi"])
    sd[f"{prefix}.bias_hh"] = _np(p["bh"])


def _bn_t(sd, prefix, p, stats):
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(stats["mean"])
    sd[f"{prefix}.running_var"] = _np(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def tacotron2_params_to_torch(variables: dict, config) -> dict:
    """flax Tacotron2 variables {'params', 'batch_stats'} -> reference
    Tacotron2MS state dict (torchaudio `_Encoder`/`_Decoder`/`_Postnet`
    layout), BatchNorm running statistics included."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {"embedding.weight": _np(params["embedding"]["embedding"])}
    for i in range(config.encoder_n_convolutions):
        _conv1d_t(sd, f"encoder.convolutions.{i}.0.conv",
                  params[f"enc_conv_{i}"])
        _bn_t(sd, f"encoder.convolutions.{i}.1", params[f"enc_bn_{i}"],
              stats[f"enc_bn_{i}"])
    _bilstm_t(sd, "encoder.lstm", params["enc_lstm"])
    if "speaker_embedding" in params:
        sd["speaker_embedding.weight"] = _np(
            params["speaker_embedding"]["embedding"])
    dec = "decoder"
    att = f"{dec}.attention_layer"
    _dense_t(sd, f"{dec}.prenet.layers.0.linear_layer", params["prenet1"],
             bias=False)
    _dense_t(sd, f"{dec}.prenet.layers.1.linear_layer", params["prenet2"],
             bias=False)
    _lstm_cell_t(sd, f"{dec}.attention_rnn", params["attention_rnn"])
    _lstm_cell_t(sd, f"{dec}.decoder_rnn", params["decoder_rnn"])
    _dense_t(sd, f"{att}.query_layer.linear_layer", params["query_layer"],
             bias=False)
    _dense_t(sd, f"{att}.memory_layer.linear_layer", params["memory_layer"],
             bias=False)
    _dense_t(sd, f"{att}.v.linear_layer", params["v"], bias=False)
    _conv1d_t(sd, f"{att}.location_layer.location_conv.conv",
              params["location_conv"])
    _dense_t(sd, f"{att}.location_layer.location_dense.linear_layer",
             params["location_dense"], bias=False)
    _dense_t(sd, f"{dec}.linear_projection.linear_layer",
             params["linear_projection"])
    _dense_t(sd, f"{dec}.gate_layer.linear_layer", params["gate_layer"])
    for i in range(config.postnet_n_convolutions):
        _conv1d_t(sd, f"postnet.convolutions.{i}.0.conv",
                  params[f"post_conv_{i}"])
        _bn_t(sd, f"postnet.convolutions.{i}.1", params[f"post_bn_{i}"],
              stats[f"post_bn_{i}"])
    return sd


def patch_discriminator_params_to_torch(variables: dict) -> tuple:
    """flax PatchDiscriminator variables {'params', 'spectral'} -> (the
    port's critic state dict, its iteration vectors): each `conv<i>`
    kernel [k, k, in, out] (HWIO) -> weight [out, in, k, k] (OIHW), its
    bias as is, and its `spectral` u [out, 1] as is."""
    sd, spectral = {}, {}
    for name, p in variables["params"].items():
        sd[f"{name}.weight"] = np.ascontiguousarray(
            _np(p["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _np(p["bias"])
        spectral[name] = _np(variables["spectral"][name]["u"])
    return sd, spectral


def diacritizer_params_to_torch(params: dict) -> dict:
    """The JAX diacritizers' numpy parameter dicts -> the reference `.pth`
    layout (the inverse of the JAX package's `_import_bilstm` and
    `_import_dense`). Shakkala: `emb`, `lstm0-2`, `bn0`, `dense0` ->
    `emb_input.weight`, `lstmN.weight_ih_l0{,_reverse}`...,
    `bn0.{weight,bias,running_mean,running_var}`, `dense0.{weight,bias}`.
    Shakkelha: `emb`, `lstm0-1`, `dense0-2` -> `emb0.weight`, ..."""
    sd = {}
    shakkala = "bn0" in params
    sd["emb_input.weight" if shakkala else "emb0.weight"] = _np(
        params["emb"])
    for name, p in params.items():
        if name.startswith("lstm"):
            _bilstm_t(sd, name, p)
        elif name.startswith("dense"):
            sd[f"{name}.weight"] = np.ascontiguousarray(_np(p["w"]).T)
            sd[f"{name}.bias"] = _np(p["b"])
        elif name == "bn0":
            sd["bn0.weight"] = _np(p["scale"])
            sd["bn0.bias"] = _np(p["bias"])
            sd["bn0.running_mean"] = _np(p["mean"])
            sd["bn0.running_var"] = _np(p["var"])
    return sd


def vocos_params_to_torch(variables: dict, num_layers: int = 8) -> dict:
    """flax MelVocos variables -> the reference MelVocos / Vocos state dict
    (the inverse of the JAX package's `vocos_params_from_torch`):
    `backbone.embed`, `backbone.norm`, `backbone.convnext.{i}.dwconv` /
    `norm` / `pwconv1` / `pwconv2` / `gamma`, `backbone.final_layer_norm`,
    `head.out`."""
    params = variables["params"]
    bb = params["backbone"]
    sd: dict = {}
    _conv1d_t(sd, "backbone.embed", bb["embed"])
    _ln_t(sd, "backbone.norm", bb["norm"])
    for i in range(num_layers):
        p, layer = f"backbone.convnext.{i}", bb[f"convnext_{i}"]
        _conv1d_t(sd, f"{p}.dwconv", layer["dwconv"])
        _ln_t(sd, f"{p}.norm", layer["norm"])
        _dense_t(sd, f"{p}.pwconv1", layer["pwconv1"])
        _dense_t(sd, f"{p}.pwconv2", layer["pwconv2"])
        sd[f"{p}.gamma"] = _np(layer["gamma"])
    _ln_t(sd, "backbone.final_layer_norm", bb["final_layer_norm"])
    _dense_t(sd, "head.out", params["head"]["out"])
    return sd


def ffn_scales_from_quant(ffn_quant: dict) -> list:
    """The JAX pipeline's decoder-FFN int8 scales (`_ffn_quant`,
    {"decoder": {"layer_{i}": {"ff": {"ffn_ascale": [2]}}}}) -> one f32
    [2] array per decoder layer, in layer order, for
    `FFTransformer.set_ffn_int8`."""
    layers = ffn_quant["decoder"]
    names = sorted(layers, key=lambda n: int(n.rsplit("_", 1)[1]))
    return [np.array(layers[n]["ff"]["ffn_ascale"], np.float32)
            for n in names]


def fold_weight_norm(sd: dict) -> dict:
    """Fold weight-norm pairs into plain weights, w = g * v / ||v||: both
    the legacy `weight_g`/`weight_v` keys and the modern
    `parametrizations.weight.original0/1` ones. Other keys pass through."""
    out = {}
    for key, val in sd.items():
        for g_suffix, v_suffix in (
                ("weight_g", "weight_v"),
                ("parametrizations.weight.original0",
                 "parametrizations.weight.original1")):
            if key.endswith(v_suffix):
                break
            if key.endswith(g_suffix):
                base = key[: -len(g_suffix)]
                g, v = _np(val), _np(sd[base + v_suffix])
                shape = (-1,) + (1,) * (v.ndim - 1)
                norm = np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(1))
                out[base + "weight"] = (g.reshape(shape) * v
                                        / norm.reshape(shape))
                break
        else:
            out[key] = val
    return out


def to_tensors(sd: dict) -> dict:
    """{key: ndarray or tensor} -> {key: tensor} for `load_state_dict`."""
    return {k: v if isinstance(v, torch.Tensor) else torch.tensor(_np(v))
            for k, v in sd.items()}


def load_reference_pth(path) -> tuple[dict, dict]:
    """Read a reference `.pth` checkpoint with `weights_only=True`.

    Handles a bare state dict or one under a 'model'/'generator'/
    'state_dict' key (reference `networks.py:52-60`,
    `vocoder/__init__.py:10-18`). Returns (state dict {key: tensor}, the
    other top-level entries such as 'config' and 'symbols')."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    extras: dict = {}
    if isinstance(raw, dict):
        for key in ("model", "generator", "state_dict"):
            if isinstance(raw.get(key), dict):
                extras = {k: v for k, v in raw.items() if k != key}
                raw = raw[key]
                break
    sd = {k.removeprefix("module."): v for k, v in raw.items()
          if isinstance(v, torch.Tensor)}
    return sd, extras
