"""Tacotron2 inference in plain float32 PyTorch, one utterance at a time,
from a state dict in the published layout (nipponjo/tts-arabic-pytorch,
`models/tacotron2/tacotron2_ms.py`: `Tacotron2MS` on torchaudio's
`_Encoder`, `_Decoder` and `_Postnet`; Shen et al., arXiv:1712.05884).

`cfg` is the configuration's `tacotron2` dict (`n_mels`, `n_symbols`,
`encoder_embedding_dim`, ...). An utterance is never padded here, so no
mask is needed: the published model masks its padding so that real
positions do not depend on it.

The prenet's dropout stays on at inference, as published. Its keep masks
are drawn by the serving program's documented rule, so that a decode here
meets the masks the program met: every step's masks of a batch of `B`
rows drawn up front, [steps + 1, 2, B, prenet_dim], as `torch.rand(...,
generator=torch.Generator(device).manual_seed(0)) < 1 - p` on the device
the batch ran on, and the utterance's row of the batch taken
(`prenet_masks`).

`decode` runs free (each step's prenet takes the decode's own previous
frame, until the gate fires or the cap) or teacher-forced (each step's
prenet takes a given previous frame, for as many steps as frames are
given); the attention and both LSTMs follow this file's own recurrence in
either mode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import text

BN_EPS = 1e-5


def ids(utterance: str) -> list[int]:
    """The model token ids of one Buckwalter utterance, tokens outside the
    symbol table dropped, with the trailing separator before the end
    token: what the published Tacotron2 wrapper feeds its encoder."""
    return text.tokens_to_ids(
        text.buckwalter_to_tokens(utterance, append_space=True), None,
        strict=False)


def memory_dim(cfg: dict) -> int:
    extra = cfg["speaker_embedding_dim"] if cfg["num_speakers"] > 1 else 0
    return cfg["encoder_embedding_dim"] + extra


def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape, init) of every state-dict entry of the published
    model; init is ("normal", std), ("zeros",) or ("ones",). Linear and
    conv weights have std 1/sqrt(fan in), conv biases 1/sqrt(3 fan in)
    (the variance of PyTorch's default uniform bias), embeddings
    1/sqrt(dim), every LSTM weight and bias 1/sqrt(3 hidden) (the variance
    of PyTorch's default U(-1/sqrt(hidden), 1/sqrt(hidden))); BatchNorm's
    scale and running variance are one, its bias, running mean and batch
    count zero."""
    out = []
    e, n_mels = cfg["encoder_embedding_dim"], cfg["n_mels"]
    mem = memory_dim(cfg)

    def lin(name, o, i, bias=False):
        out.append((f"{name}.linear_layer.weight", (o, i),
                    ("normal", i ** -0.5)))
        if bias:
            out.append((f"{name}.linear_layer.bias", (o,),
                        ("normal", (3 * i) ** -0.5)))

    def conv(name, o, i, k, bias=True):
        out.append((f"{name}.conv.weight", (o, i, k),
                    ("normal", (i * k) ** -0.5)))
        if bias:
            out.append((f"{name}.conv.bias", (o,),
                        ("normal", (3 * i * k) ** -0.5)))

    def batch_norm(name, n):
        out.extend([(f"{name}.weight", (n,), ("ones",)),
                    (f"{name}.bias", (n,), ("zeros",)),
                    (f"{name}.running_mean", (n,), ("zeros",)),
                    (f"{name}.running_var", (n,), ("ones",)),
                    (f"{name}.num_batches_tracked", (), ("zeros",))])

    def lstm(name, n_in, hidden, suffix=""):
        std = ("normal", (3 * hidden) ** -0.5)
        out.extend([(f"{name}.weight_ih{suffix}", (4 * hidden, n_in), std),
                    (f"{name}.weight_hh{suffix}", (4 * hidden, hidden), std),
                    (f"{name}.bias_ih{suffix}", (4 * hidden,), std),
                    (f"{name}.bias_hh{suffix}", (4 * hidden,), std)])

    def conv_stack(name, dims, k):
        for i in range(len(dims) - 1):
            conv(f"{name}.{i}.0", dims[i + 1], dims[i], k)
            batch_norm(f"{name}.{i}.1", dims[i + 1])

    out.append(("embedding.weight",
                (cfg["n_symbols"], cfg["symbol_embedding_dim"]),
                ("normal", cfg["symbol_embedding_dim"] ** -0.5)))
    conv_stack("encoder.convolutions",
               [cfg["symbol_embedding_dim"]]
               + [e] * cfg["encoder_n_convolutions"],
               cfg["encoder_kernel_size"])
    lstm("encoder.lstm", e, e // 2, "_l0")
    lstm("encoder.lstm", e, e // 2, "_l0_reverse")
    if cfg["num_speakers"] > 1:
        d = cfg["speaker_embedding_dim"]
        out.append(("speaker_embedding.weight", (cfg["num_speakers"], d),
                    ("normal", d ** -0.5)))
    pre, a, dec = (cfg["prenet_dim"], cfg["attention_rnn_dim"],
                   cfg["decoder_rnn_dim"])
    ah, nf = cfg["attention_hidden_dim"], cfg["attention_location_n_filters"]
    lin("decoder.prenet.layers.0", pre, n_mels)
    lin("decoder.prenet.layers.1", pre, pre)
    lstm("decoder.attention_rnn", pre + mem, a)
    lin("decoder.attention_layer.query_layer", ah, a)
    lin("decoder.attention_layer.memory_layer", ah, mem)
    lin("decoder.attention_layer.v", 1, ah)
    conv("decoder.attention_layer.location_layer.location_conv", nf, 2,
         cfg["attention_location_kernel_size"], bias=False)
    lin("decoder.attention_layer.location_layer.location_dense", ah, nf)
    lstm("decoder.decoder_rnn", a + mem, dec)
    lin("decoder.linear_projection", n_mels, dec + mem, bias=True)
    lin("decoder.gate_layer", 1, dec + mem, bias=True)
    p = cfg["postnet_embedding_dim"]
    conv_stack("postnet.convolutions",
               [n_mels] + [p] * (cfg["postnet_n_convolutions"] - 1)
               + [n_mels], cfg["postnet_kernel_size"])
    return out


def _conv_bn(x, sd, name):
    """SAME conv, then BatchNorm on its running statistics: x [C, T]."""
    w = sd[f"{name}.0.conv.weight"]
    y = F.conv1d(x[None], w, sd[f"{name}.0.conv.bias"],
                 padding=(w.shape[-1] - 1) // 2)[0]
    bn = f"{name}.1"
    scale = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + BN_EPS)
    return ((y - sd[f"{bn}.running_mean"][:, None]) * scale[:, None]
            + sd[f"{bn}.bias"][:, None])


def _lstm_cell(x, h, c, sd, name, suffix=""):
    """PyTorch's LSTM cell (gates in the order i, f, g, o)."""
    g = (x @ sd[f"{name}.weight_ih{suffix}"].t()
         + sd[f"{name}.bias_ih{suffix}"]
         + h @ sd[f"{name}.weight_hh{suffix}"].t()
         + sd[f"{name}.bias_hh{suffix}"])
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _linear(x, sd, name):
    y = x @ sd[f"{name}.linear_layer.weight"].t()
    bias = sd.get(f"{name}.linear_layer.bias")
    return y if bias is None else y + bias


def encode(sd: dict, cfg: dict, token_ids, speaker: int) -> dict:
    """One utterance's token ids -> the decoder's memory [T, mem] (the
    encoder's BiLSTM output, the speaker embedding concatenated) and its
    attention keys [T, attention_hidden_dim]."""
    dev = sd["embedding.weight"].device
    tokens = torch.as_tensor(token_ids, dtype=torch.long, device=dev)
    x = sd["embedding.weight"][tokens].t()                 # [E, T]
    for i in range(cfg["encoder_n_convolutions"]):
        x = torch.relu(_conv_bn(x, sd, f"encoder.convolutions.{i}"))
    x = x.t()                                               # [T, E]
    T, hidden = x.shape[0], cfg["encoder_embedding_dim"] // 2
    outs = []
    for suffix, steps in (("_l0", range(T)),
                          ("_l0_reverse", range(T - 1, -1, -1))):
        h = c = x.new_zeros(hidden)
        seq = [None] * T
        for t in steps:
            h, c = _lstm_cell(x[t], h, c, sd, "encoder.lstm", suffix)
            seq[t] = h
        outs.append(torch.stack(seq))
    memory = torch.cat(outs, dim=1)
    if cfg["num_speakers"] > 1:
        spk = sd["speaker_embedding.weight"][int(speaker)]
        memory = torch.cat([memory, spk[None].expand(T, -1)], dim=1)
    keys = _linear(memory, sd, "decoder.attention_layer.memory_layer")
    return {"memory": memory, "keys": keys}


def prenet_masks(cfg: dict, n_steps: int, batch: int, device) -> torch.Tensor:
    """The keep masks of every step of a batch of `batch` rows decoded to
    at most `n_steps` steps, bool [n_steps + 1, 2, batch, prenet_dim]: the
    serving program's rule (the module's docstring). Take an utterance's
    with `[:, :, row]`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shape = (n_steps + 1, 2, batch, cfg["prenet_dim"])
    return (torch.rand(shape, generator=gen, device=device)
            < 1.0 - cfg["prenet_dropout"])


def decode(sd: dict, cfg: dict, enc: dict, masks: torch.Tensor, *,
           frames: torch.Tensor | None = None,
           max_steps: int | None = None,
           align: torch.Tensor | None = None) -> dict:
    """The autoregressive decode of one utterance. `masks` [steps + 1, 2,
    prenet_dim]: its prenet keep masks, step t's at [t].

    Free-running (`frames` None): step t's prenet takes the frame step
    t - 1 made (zeros at t = 0); the decode stops after the first step
    whose sigmoid(gate) passes `gate_threshold`, or after `max_steps`.
    Teacher-forced: step t's prenet takes `frames[t - 1]` ([L, n_mels]),
    for L steps. With `align` ([L, T], another decode's attention weights)
    step t's location features read `align[t - 1]` and the running sum of
    `align[:t]` in place of this decode's own: its attention, context and
    everything after them are still its own, from that state.

    -> {mel [L, n_mels], gate [L] (logits), align [L, T]}."""
    memory, keys = enc["memory"], enc["keys"]
    T = memory.shape[0]
    a_dim, d_dim = cfg["attention_rnn_dim"], cfg["decoder_rnn_dim"]
    n_steps = frames.shape[0] if frames is not None else max_steps
    scale = 1.0 / (1.0 - cfg["prenet_dropout"])
    w_loc = sd["decoder.attention_layer.location_layer.location_conv"
               ".conv.weight"]
    attn_h = attn_c = memory.new_zeros(a_dim)
    dec_h = dec_c = memory.new_zeros(d_dim)
    weights = cum = memory.new_zeros(T)
    context = memory.new_zeros(memory.shape[1])
    prev = memory.new_zeros(cfg["n_mels"])
    mels, gates, aligns = [], [], []
    for t in range(n_steps):
        x = prev if frames is None or t == 0 else frames[t - 1]
        for i in range(2):
            x = torch.relu(_linear(x, sd, f"decoder.prenet.layers.{i}"))
            x = torch.where(masks[t, i], x * scale, 0.0)
        attn_h, attn_c = _lstm_cell(torch.cat([x, context]), attn_h, attn_c,
                                    sd, "decoder.attention_rnn")
        query = _linear(attn_h, sd, "decoder.attention_layer.query_layer")
        loc = F.conv1d(torch.stack([weights, cum])[None], w_loc,
                       padding=(w_loc.shape[-1] - 1) // 2)[0].t()
        loc = _linear(loc, sd, "decoder.attention_layer.location_layer"
                      ".location_dense")
        energies = _linear(torch.tanh(query + loc + keys), sd,
                           "decoder.attention_layer.v")[:, 0]
        own = torch.softmax(energies, dim=0)
        context = own @ memory
        weights = own if align is None else align[t]
        cum = cum + weights
        dec_h, dec_c = _lstm_cell(torch.cat([attn_h, context]), dec_h,
                                  dec_c, sd, "decoder.decoder_rnn")
        out = torch.cat([dec_h, context])
        prev = _linear(out, sd, "decoder.linear_projection")
        gate = _linear(out, sd, "decoder.gate_layer")[0]
        mels.append(prev)
        gates.append(gate)
        aligns.append(own)
        if frames is None and torch.sigmoid(gate) > cfg["gate_threshold"]:
            break
    return {"mel": torch.stack(mels), "gate": torch.stack(gates),
            "align": torch.stack(aligns)}


def postnet(sd: dict, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [L, n_mels] -> mel + the postnet's residual [L, n_mels]."""
    x = mel.t()
    n = cfg["postnet_n_convolutions"]
    for i in range(n):
        x = _conv_bn(x, sd, f"postnet.convolutions.{i}")
        if i < n - 1:
            x = torch.tanh(x)
    return mel + x.t()
