"""FastPitch inference in plain float32 PyTorch, one utterance at a time,
from a state dict in the published layout (nipponjo/tts-arabic-pytorch,
`models/fastpitch/fastpitch/model.py` and `transformer.py`).

`net` is the published `net_config` dict (`symbols_embedding_dim`,
`in_fft_n_layers`, ...). An utterance is never padded here, so no mask is
needed: the published model masks its padding so that real positions do
not depend on it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_specs(net: dict) -> list[tuple]:
    """(name, shape, init) of every state-dict entry of the published
    model: init is ("normal", std), ("zeros",), ("ones",) or
    ("inv_freq", dim). Standard deviations are 1/sqrt(fan in) for linear
    and conv weights, 1/sqrt(3 fan in) for their biases (the variance of
    PyTorch's default uniform bias) and 1/sqrt(dim) for embeddings;
    LayerNorm scales are one and its biases zero."""
    d = net["symbols_embedding_dim"]
    out = [("pitch_mean", (1,), ("zeros",)), ("pitch_std", (1,), ("zeros",))]

    def lin(name, o, i, bias=True):
        out.append((f"{name}.weight", (o, i), ("normal", i ** -0.5)))
        if bias:
            out.append((f"{name}.bias", (o,), ("normal", (3 * i) ** -0.5)))

    def conv(name, o, i, k):
        out.append((f"{name}.weight", (o, i, k), ("normal", (i * k) ** -0.5)))
        out.append((f"{name}.bias", (o,), ("normal", (3 * i * k) ** -0.5)))

    def norm(name, n):
        out.append((f"{name}.weight", (n,), ("ones",)))
        out.append((f"{name}.bias", (n,), ("zeros",)))

    def fft(name, pre, embed):
        if embed:
            out.append((f"{name}.word_emb.weight", (net["n_symbols"], d),
                        ("normal", d ** -0.5)))
        out.append((f"{name}.pos_emb.inv_freq", (d // 2,), ("inv_freq", d)))
        h, dh = net[f"{pre}_fft_n_heads"], net[f"{pre}_fft_d_head"]
        k, f = (net[f"{pre}_fft_conv1d_kernel_size"],
                net[f"{pre}_fft_conv1d_filter_size"])
        for i in range(net[f"{pre}_fft_n_layers"]):
            p = f"{name}.layers.{i}"
            lin(f"{p}.dec_attn.qkv_net", 3 * h * dh, d)
            lin(f"{p}.dec_attn.o_net", d, h * dh, bias=False)
            norm(f"{p}.dec_attn.layer_norm", d)
            conv(f"{p}.pos_ff.CoreNet.0", f, d, k)
            conv(f"{p}.pos_ff.CoreNet.2", d, f, k)
            norm(f"{p}.pos_ff.layer_norm", d)

    def predictor(name, pre):
        f, k = (net[f"{pre}_predictor_filter_size"],
                net[f"{pre}_predictor_kernel_size"])
        for i in range(net[f"{pre}_predictor_n_layers"]):
            conv(f"{name}.layers.{i}.conv", f, d if i == 0 else f, k)
            norm(f"{name}.layers.{i}.norm", f)
        lin(f"{name}.fc", 1, f)

    fft("encoder", "in", True)
    fft("decoder", "out", False)
    predictor("duration_predictor", "dur")
    predictor("pitch_predictor", "pitch")
    conv("pitch_emb", d, 1, net["pitch_embedding_kernel_size"])
    if net["energy_conditioning"]:
        predictor("energy_predictor", "energy")
        conv("energy_emb", d, 1, net["energy_embedding_kernel_size"])
    if net["n_speakers"] > 1:
        out.append(("speaker_emb.weight", (net["n_speakers"], d),
                    ("normal", d ** -0.5)))
    lin("proj", net["n_mel_channels"], d)
    # the soft aligner, used only in training, kept so the layout is whole
    n_mel, att = net["n_mel_channels"], 80
    conv("attention.key_proj.0.conv", 2 * d, d, 3)
    conv("attention.key_proj.2.conv", att, 2 * d, 1)
    conv("attention.query_proj.0.conv", 2 * n_mel, n_mel, 3)
    conv("attention.query_proj.2.conv", n_mel, 2 * n_mel, 1)
    conv("attention.query_proj.4.conv", att, n_mel, 1)
    out.append(("attention.attn_proj.weight", (1, att, 1, 1),
                ("normal", att ** -0.5)))
    out.append(("attention.attn_proj.bias", (1,), ("zeros",)))
    return out


def _conv(x, sd, name):
    """SAME conv on x [T, C] -> [T, C_out]."""
    w = sd[f"{name}.weight"]
    y = F.conv1d(x.t()[None], w, sd[f"{name}.bias"],
                 padding=(w.shape[-1] - 1) // 2)
    return y[0].t()


def _norm(x, sd, name):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], 1e-5)


def _positions(n: int, d: int, device) -> torch.Tensor:
    inv_freq = 1.0 / (10000 ** (torch.arange(0.0, d, 2.0,
                                             dtype=torch.float64) / d))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv_freq[None]
    return torch.cat([ang.sin(), ang.cos()], 1).float().to(device)


def _fft(x, sd, net, name, pre):
    h, dh = net[f"{pre}_fft_n_heads"], net[f"{pre}_fft_d_head"]
    T = x.shape[0]
    x = x + _positions(T, x.shape[1], x.device)
    for i in range(net[f"{pre}_fft_n_layers"]):
        p = f"{name}.layers.{i}"
        qkv = F.linear(x, sd[f"{p}.dec_attn.qkv_net.weight"],
                       sd[f"{p}.dec_attn.qkv_net.bias"])
        q, k, v = qkv.reshape(T, 3, h, dh).unbind(1)
        probs = torch.softmax(torch.einsum("qhd,khd->hqk", q, k)
                              / math.sqrt(dh), dim=-1)
        att = torch.einsum("hqk,khd->qhd", probs, v).reshape(T, h * dh)
        x = _norm(x + F.linear(att, sd[f"{p}.dec_attn.o_net.weight"]), sd,
                  f"{p}.dec_attn.layer_norm")
        y = _conv(torch.relu(_conv(x, sd, f"{p}.pos_ff.CoreNet.0")), sd,
                  f"{p}.pos_ff.CoreNet.2")
        x = _norm(x + y, sd, f"{p}.pos_ff.layer_norm")
    return x


def _predict(x, sd, net, name, pre):
    for i in range(net[f"{pre}_predictor_n_layers"]):
        x = _norm(torch.relu(_conv(x, sd, f"{name}.layers.{i}.conv")), sd,
                  f"{name}.layers.{i}.norm")
    return F.linear(x, sd[f"{name}.fc.weight"], sd[f"{name}.fc.bias"])


def _encoder(sd: dict, net: dict, ids) -> torch.Tensor:
    tokens = torch.as_tensor(ids, dtype=torch.long,
                             device=sd["proj.weight"].device)
    return _fft(F.embedding(tokens, sd["encoder.word_emb.weight"]), sd, net,
                "encoder", "in")


def log_durations(sd: dict, net: dict, ids) -> torch.Tensor:
    """The duration head's output [T] (log(1 + frames)) of one utterance."""
    x = _encoder(sd, net, ids)
    return _predict(x, sd, net, "duration_predictor", "dur")[:, 0]


def encode(sd: dict, net: dict, ids) -> dict:
    """Token ids of one utterance -> the conditioned encoder states
    [T, d] and the predicted durations [T] in frames (not rounded)."""
    x = _encoder(sd, net, ids)
    log_dur = _predict(x, sd, net, "duration_predictor", "dur")[:, 0]
    dur = torch.clamp(torch.exp(log_dur) - 1.0, 0.0, 75.0)
    pitch = _predict(x, sd, net, "pitch_predictor", "pitch")
    x = x + _conv(pitch, sd, "pitch_emb")
    if net["energy_conditioning"]:
        energy = _predict(x, sd, net, "energy_predictor", "energy")
        x = x + _conv(energy, sd, "energy_emb")
    return {"enc_out": x, "dur": dur}


def decode(sd: dict, net: dict, enc_out: torch.Tensor,
           reps: torch.Tensor) -> torch.Tensor:
    """Each token's state repeated `reps` (integer) times, then the
    decoder and the mel projection -> mel [frames, n_mel]."""
    x = torch.repeat_interleave(enc_out, reps.to(torch.long), dim=0)
    x = _fft(x, sd, net, "decoder", "out")
    return F.linear(x, sd["proj.weight"], sd["proj.bias"])
