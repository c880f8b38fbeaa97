"""Tacotron2 acoustic model (torch counterpart of the JAX package's
`models/tacotron2.py`): autoregressive text -> mel.

Reference `Tacotron2MS` (torchaudio's `_Encoder`, `_Decoder`, `_Postnet`):

- encoder: 3 x [conv512 k5 -> BatchNorm -> ReLU] -> BiLSTM(2 x 256) with
  packed-sequence semantics (the backward pass starts at each row's own
  length); optional 128-dim speaker embedding concatenated to its output
- decoder: prenet (2 x 256, dropout ALWAYS on) -> attention LSTM (1024) ->
  location-sensitive attention (128 hidden, 32 filters, k31) -> decoder
  LSTM (1024) -> mel and gate projections
- postnet: 5 x conv512 k5 BatchNorm tanh, residual

Parameter names follow the reference state dict, so a published `.pth`
loads with `strict=True`. The module holds float32 weights; every method
takes a `dtype` and casts the weights to it at use (the JAX pipeline's
`cast_floating`), so one module serves the float32 and the bf16 decode.

The decode on the card. The JAX package runs inference as one compiled
`lax.while_loop` with early exit. Here every decoder step is one
*predicated* step (`_predicated_step`): it runs whether or not the loop
would still run, and a device-side flag `go` ("some row unfinished and
s < limit") masks every write it makes: the state, `prev_frame`,
`finished`, `lengths`, `t`, `s` and the mel, gate and align buffers. So a
block of DECODE_BLOCK steps (`decode_block`) may run past the JAX loop's
exit and leaves every output exactly as JAX leaves it, and the host reads
the flag once per block, not once per step. The block takes its inputs
from, and writes its results into, tensors it is given, so the pipeline
can record one block as a CUDA graph and replay it.

Training (`forward_train`) runs the teacher-forced steps as a Python loop
of `_decode_step`s with the training dropouts, every mask drawn from one
explicit generator, and BatchNorm on the batch's statistics as flax
computes them (`_batch_norm_train`).

The prenet dropout draws its masks for every step of a call up front
(`prenet_masks`, from an explicit generator) and a step indexes them with
its device-side `t`: a step's mask depends only on the call and on `t`,
as in JAX, where the step folds `t` into one key. No generator state
lives inside a block.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime.profiling import count, enabled, span
from .layers import dropout, init_weights, sequence_mask

_NEG_INF = -1e9

# predicated decoder steps per block: the host reads the run flag once per
# block, and a block runs at most DECODE_BLOCK - 1 steps past the exit
DECODE_BLOCK = 16

# flax's BatchNorm in training: running = 0.9 running + 0.1 batch
_BN_MOMENTUM = 0.9

# decoder state carried from step to step, besides the bookkeeping
STATE_KEYS = ("attn_h", "attn_c", "dec_h", "dec_c", "attn_weights",
              "attn_weights_cum", "attn_context", "prev_frame")


@dataclasses.dataclass(frozen=True)
class Tacotron2Config:
    n_mels: int = 80
    n_symbols: int = 40
    symbol_embedding_dim: int = 512
    encoder_embedding_dim: int = 512
    encoder_n_convolutions: int = 3
    encoder_kernel_size: int = 5
    num_speakers: int = 1
    speaker_embedding_dim: int = 128
    decoder_rnn_dim: int = 1024
    decoder_max_step: int = 2000
    decoder_dropout: float = 0.1
    decoder_early_stopping: bool = True
    attention_rnn_dim: int = 1024
    attention_hidden_dim: int = 128
    attention_location_n_filters: int = 32
    attention_location_kernel_size: int = 31
    attention_dropout: float = 0.1
    prenet_dim: int = 256
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    gate_threshold: float = 0.5
    # torchaudio's prenet hardcodes dropout 0.5 in inference too; 0.0 makes
    # the decode deterministic (parity tests against the JAX package)
    prenet_dropout: float = 0.5

    @property
    def memory_dim(self) -> int:
        extra = (self.speaker_embedding_dim if self.num_speakers > 1 else 0)
        return self.encoder_embedding_dim + extra


# --- reference-layout wrappers ----------------------------------------------

class _Conv(nn.Module):
    """`<prefix>.conv`: a SAME-padded Conv1d (odd kernel sizes)."""

    def __init__(self, c_in: int, c_out: int, k: int, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C_in, T] channels-first -> [B, C_out, T] in x's dtype."""
        c = self.conv
        b = None if c.bias is None else c.bias.to(x.dtype)
        return F.conv1d(x, c.weight.to(x.dtype), b,
                        padding=(c.weight.shape[-1] - 1) // 2)


class _Linear(nn.Module):
    """`<prefix>.linear_layer`."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(d_in, d_out, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lin = self.linear_layer
        b = None if lin.bias is None else lin.bias.to(x.dtype)
        return F.linear(x, lin.weight.to(x.dtype), b)


def _batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """BatchNorm in eval (running statistics), channels-first x."""
    dt = x.dtype
    return F.batch_norm(x, bn.running_mean.to(dt), bn.running_var.to(dt),
                        bn.weight.to(dt), bn.bias.to(dt), False, 0.0, bn.eps)


def _batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d,
                      update: bool = True, stats_sum=None) -> torch.Tensor:
    """BatchNorm in training, as flax computes it (channels-first x): the
    batch's mean and biased variance over (B, T), pad positions included,
    the variance as E[x^2] - E[x]^2 clipped at 0; with `update`, the
    running statistics move to 0.9 running + 0.1 batch, the variance
    biased (torch's `F.batch_norm` would move them by the unbiased
    one). `stats_sum` (data parallelism: a differentiable sum over the
    ranks, `parallel.all_reduce_sum`) takes the statistics over the
    global batch, so every rank normalizes, and moves its running
    statistics, as JAX's one program over the global batch does."""
    if stats_sum is None:
        mean = x.mean((0, 2))
        var = torch.clamp((x * x).mean((0, 2)) - mean * mean, min=0.0)
    else:
        C = x.shape[1]
        tot = stats_sum(torch.cat([
            x.sum((0, 2)), (x * x).sum((0, 2)),
            x.new_full((1,), float(x.shape[0] * x.shape[2]))]))
        mean = tot[:C] / tot[-1]
        var = torch.clamp(tot[C:2 * C] / tot[-1] - mean * mean, min=0.0)
    if update:
        with torch.no_grad():
            bn.running_mean.copy_(_BN_MOMENTUM * bn.running_mean
                                  + (1 - _BN_MOMENTUM) * mean)
            bn.running_var.copy_(_BN_MOMENTUM * bn.running_var
                                 + (1 - _BN_MOMENTUM) * var)
            bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None]) * mul[:, None] + bn.bias[:, None]


def _conv_bn_stack(n: int, c_in: int, c_mid: int, c_out: int,
                   k: int) -> nn.ModuleList:
    dims = [c_in] + [c_mid] * (n - 1) + [c_out]
    return nn.ModuleList(
        nn.Sequential(_Conv(dims[i], dims[i + 1], k),
                      nn.BatchNorm1d(dims[i + 1], eps=1e-5))
        for i in range(n))


class _Encoder(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        e = c.encoder_embedding_dim
        self.convolutions = _conv_bn_stack(
            c.encoder_n_convolutions, c.symbol_embedding_dim, e, e,
            c.encoder_kernel_size)
        self.lstm = nn.LSTM(e, e // 2, batch_first=True, bidirectional=True)


class _Prenet(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        self.layers = nn.ModuleList([
            _Linear(c.n_mels, c.prenet_dim, bias=False),
            _Linear(c.prenet_dim, c.prenet_dim, bias=False)])


class _Location(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        self.location_conv = _Conv(2, c.attention_location_n_filters,
                                   c.attention_location_kernel_size,
                                   bias=False)
        self.location_dense = _Linear(c.attention_location_n_filters,
                                      c.attention_hidden_dim, bias=False)


class _Attention(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        h = c.attention_hidden_dim
        self.query_layer = _Linear(c.attention_rnn_dim, h, bias=False)
        self.memory_layer = _Linear(c.memory_dim, h, bias=False)
        self.v = _Linear(h, 1, bias=False)
        self.location_layer = _Location(c)


class _Decoder(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        mem = c.memory_dim
        self.prenet = _Prenet(c)
        self.attention_rnn = nn.LSTMCell(c.prenet_dim + mem,
                                         c.attention_rnn_dim)
        self.attention_layer = _Attention(c)
        self.decoder_rnn = nn.LSTMCell(c.attention_rnn_dim + mem,
                                       c.decoder_rnn_dim)
        self.linear_projection = _Linear(c.decoder_rnn_dim + mem, c.n_mels)
        self.gate_layer = _Linear(c.decoder_rnn_dim + mem, 1)


class _Postnet(nn.Module):
    def __init__(self, c: Tacotron2Config):
        super().__init__()
        self.convolutions = _conv_bn_stack(
            c.postnet_n_convolutions, c.n_mels, c.postnet_embedding_dim,
            c.n_mels, c.postnet_kernel_size)

    def forward(self, mel: torch.Tensor,
                mel_lens: Optional[torch.Tensor] = None, *,
                norm: Callable = _batch_norm,
                drop: Optional[Callable] = None) -> torch.Tensor:
        """mel [B, T, n_mels] -> the residual [B, T, n_mels], in mel's
        dtype. With `mel_lens`, every conv input is re-masked to zero past
        each length (pad-invariance, as in `Tacotron2.encode`). `norm`
        and `drop` (training: `Tacotron2.forward_train`) are the
        BatchNorm and the dropout after each block."""
        m = (None if mel_lens is None
             else sequence_mask(mel_lens, mel.shape[1])[:, None, :])
        x = mel.transpose(1, 2)
        n = len(self.convolutions)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = norm(conv(x if m is None else torch.where(m, x, 0.0)), bn)
            if i < n - 1:
                x = torch.tanh(x)
            if drop is not None:
                x = drop(x)
        return x.transpose(1, 2)


def init_tacotron2(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random init: `layers.init_weights` for the embeddings, convs
    and linears; LSTM weights and biases U(-1/sqrt(H), 1/sqrt(H)) (the JAX
    package's LSTM init) from a generator of the same seed; BatchNorm at
    its identity. Drawn on the CPU, so the result does not depend on the
    device."""
    init_weights(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.LSTM, nn.LSTMCell)):
                s = mod.hidden_size ** -0.5
                for p in mod.parameters():
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * s)
    return model


# --- the model ----------------------------------------------------------------

class Tacotron2(nn.Module):
    """Reference `Tacotron2MS` in the reference state-dict layout."""

    # the encoder's and the postnet's dropout in training (hard-coded, as
    # in torchaudio and the JAX package)
    CONV_DROPOUT = 0.5

    def __init__(self, config: Tacotron2Config = Tacotron2Config()):
        super().__init__()
        c = self.config = config
        self.embedding = nn.Embedding(c.n_symbols, c.symbol_embedding_dim)
        self.encoder = _Encoder(c)
        if c.num_speakers > 1:
            self.speaker_embedding = nn.Embedding(c.num_speakers,
                                                  c.speaker_embedding_dim)
        self.decoder = _Decoder(c)
        self.postnet = _Postnet(c)

    # ---- encoder -------------------------------------------------------------

    def _bilstm(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """BiLSTM over [B, T, C] with packed-sequence semantics, in x's
        dtype (the weights cast to it); zeros past each length. Each
        direction runs over the padded rows, the backward one on each row
        reversed within its length, so no packed sequence is needed: its
        batch sizes would be read on the host, which neither a tracer
        (`torch.export`) nor a CUDA graph can follow."""
        lstm = self.encoder.lstm
        B, T, _ = x.shape
        t = torch.arange(T, device=x.device)[None, :]
        valid = t < lens[:, None]
        # row b's step t reads step lens[b] - 1 - t; pads stay in place
        rev = torch.where(valid, lens[:, None] - 1 - t, t)[..., None]

        def run(seq, suffix):
            w = [getattr(lstm, f"{n}_l0{suffix}").to(x.dtype)
                 for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            h0 = x.new_zeros(1, B, lstm.hidden_size)
            out = torch.lstm(seq, (h0, h0), w, True, 1, 0.0, lstm.training,
                             False, True)[0]
            return torch.where(valid[..., None], out, 0.0)

        fwd = run(x, "")
        bwd = run(x.gather(1, rev.expand_as(x)), "_reverse")
        bwd = bwd.gather(1, rev.expand_as(bwd))
        return torch.cat([fwd, bwd], dim=-1)

    def encode(self, tokens: torch.Tensor, token_lens: torch.Tensor,
               speaker_ids: Optional[torch.Tensor] = None, *,
               dtype: torch.dtype = torch.float32,
               norm: Callable = _batch_norm,
               drop: Optional[Callable] = None) -> torch.Tensor:
        """tokens [B, T] -> memory [B, T, memory_dim] in `dtype`.

        Every conv input is re-masked so pad positions read as zeros, the
        values the reference's exact-length run sees past the sequence
        end, which makes the encoding pad-invariant (the JAX package's
        rule; the reference itself leaks pad values between its stacked
        convs when batching). `norm` and `drop`: as in `_Postnet`."""
        c = self.config
        x = F.embedding(tokens, self.embedding.weight.to(dtype))
        m = sequence_mask(token_lens.to(tokens.device),
                          tokens.shape[1])[:, None, :]
        x = x.transpose(1, 2)
        for conv, bn in self.encoder.convolutions:
            x = torch.relu(norm(conv(torch.where(m, x, 0.0)), bn))
            if drop is not None:
                x = drop(x)
        x = self._bilstm(x.transpose(1, 2), token_lens.to(tokens.device))
        if c.num_speakers > 1:
            if speaker_ids is None:
                speaker_ids = torch.zeros(tokens.shape[0], dtype=torch.long,
                                          device=tokens.device)
            spk = F.embedding(speaker_ids.to(tokens.device).long(),
                              self.speaker_embedding.weight.to(dtype))
            x = torch.cat([x, spk[:, None, :].expand(
                -1, x.shape[1], -1)], dim=-1)
        return x

    def encode_infer(self, tokens: torch.Tensor,
                     token_lens: Optional[torch.Tensor] = None,
                     speaker_ids: Optional[torch.Tensor] = None, *,
                     dtype: torch.dtype = torch.float32,
                     **encode_kw) -> dict:
        """Encoder pass + attention-key precomputation for the decode
        (`encode_kw`: `encode`'s norm and drop)."""
        B, T_txt = tokens.shape
        if token_lens is None:
            token_lens = torch.full((B,), T_txt, dtype=torch.int32)
        memory = self.encode(tokens, token_lens, speaker_ids, dtype=dtype,
                             **encode_kw)
        return {
            "memory": memory,
            "processed_memory":
                self.decoder.attention_layer.memory_layer(memory),
            "memory_mask": sequence_mask(token_lens.to(tokens.device),
                                         T_txt),
        }

    # ---- decoder core --------------------------------------------------------

    def decoder_weights(self, dtype: torch.dtype) -> dict:
        """The decoder's weights in `dtype` (the same tensors in float32),
        the mel and gate projections stacked into one."""
        d = self.decoder
        a = d.attention_layer
        cast = lambda p: p.to(dtype)  # noqa: E731

        def cell(m):
            return tuple(cast(p) for p in (m.weight_ih, m.weight_hh,
                                           m.bias_ih, m.bias_hh))
        proj, gate = d.linear_projection.linear_layer, d.gate_layer.linear_layer
        return {
            "prenet": [cast(l.linear_layer.weight) for l in d.prenet.layers],
            "attention_rnn": cell(d.attention_rnn),
            "decoder_rnn": cell(d.decoder_rnn),
            "query": cast(a.query_layer.linear_layer.weight),
            "v": cast(a.v.linear_layer.weight),
            "location_conv": cast(a.location_layer.location_conv.conv.weight),
            "location_dense":
                cast(a.location_layer.location_dense.linear_layer.weight),
            "out_w": cast(torch.cat([proj.weight, gate.weight])),
            "out_b": cast(torch.cat([proj.bias, gate.bias])),
        }

    def prenet_masks(self, n_steps: int, batch: int, device,
                     generator: Optional[torch.Generator] = None):
        """The prenet's keep masks for steps 0..n_steps (one row past the
        last step, for a block's predicated steps past the limit):
        bool [n_steps + 1, 2, batch, prenet_dim], drawn from `generator`
        (a fresh one seeded 0 on `device` when None, so every call draws
        the same masks, as JAX's default key PRNGKey(0) does). None when
        the prenet dropout is 0."""
        p = self.config.prenet_dropout
        if p == 0.0:
            return None
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        shape = (n_steps + 1, 2, batch, self.config.prenet_dim)
        return torch.rand(shape, generator=generator, device=device) < 1.0 - p

    def _prenet(self, x: torch.Tensor, w: dict,
                masks: Optional[torch.Tensor]) -> torch.Tensor:
        """Prenet with always-on dropout: `masks` [2, B, prenet_dim] (this
        step's keep masks), or None when the dropout is 0."""
        scale = 1.0 / (1.0 - self.config.prenet_dropout)
        for i, weight in enumerate(w["prenet"]):
            x = torch.relu(F.linear(x, weight))
            if masks is not None:
                x = torch.where(masks[i], x * scale, 0.0)
        return x

    def _attend(self, query, memory, processed_memory, attn_cat, memory_mask,
                w):
        """Location-sensitive attention; attn_cat [B, 2, T] (the previous
        and the cumulative weights). -> (context [B, M], weights [B, T])."""
        loc = F.conv1d(attn_cat, w["location_conv"],
                       padding=(w["location_conv"].shape[-1] - 1) // 2)
        loc = F.linear(loc.transpose(1, 2), w["location_dense"])
        energies = F.linear(torch.tanh(
            F.linear(query, w["query"])[:, None, :] + loc + processed_memory),
            w["v"])[..., 0]
        energies = torch.where(memory_mask, energies, _NEG_INF)
        weights = torch.softmax(energies, dim=1)
        context = torch.bmm(weights[:, None, :], memory)[:, 0]
        return context, weights

    def _decode_step(self, state: dict, prenet_out: torch.Tensor, enc: dict,
                     w: dict, keep: Optional[tuple] = None):
        """One decoder step -> (new state, mel frame [B, n_mels],
        gate logit [B], attention weights [B, T]). `keep` (training): this
        step's keep masks of the attention and the decoder LSTM's output,
        which is dropped before it is used and carried."""
        c = self.config
        n_mels = c.n_mels
        att_keep, dec_keep = keep or (None, None)
        ctx = state["attn_context"]
        attn_h, attn_c = torch.lstm_cell(
            torch.cat([prenet_out, ctx], dim=-1),
            (state["attn_h"], state["attn_c"]), *w["attention_rnn"])
        if att_keep is not None:
            attn_h = torch.where(att_keep, attn_h / (1 - c.attention_dropout),
                                 0.0)
        attn_cat = torch.stack([state["attn_weights"],
                                state["attn_weights_cum"]], dim=1)
        context, weights = self._attend(attn_h, enc["memory"],
                                        enc["processed_memory"], attn_cat,
                                        enc["memory_mask"], w)
        dec_h, dec_c = torch.lstm_cell(
            torch.cat([attn_h, context], dim=-1),
            (state["dec_h"], state["dec_c"]), *w["decoder_rnn"])
        if dec_keep is not None:
            dec_h = torch.where(dec_keep, dec_h / (1 - c.decoder_dropout),
                                0.0)
        out = F.linear(torch.cat([dec_h, context], dim=-1), w["out_w"],
                       w["out_b"])
        mel_frame, gate = out[:, :n_mels], out[:, n_mels]
        new_state = {
            "attn_h": attn_h, "attn_c": attn_c, "dec_h": dec_h,
            "dec_c": dec_c, "attn_weights": weights,
            "attn_weights_cum": state["attn_weights_cum"] + weights,
            "attn_context": context, "prev_frame": mel_frame,
        }
        return new_state, mel_frame, gate, weights

    # ---- teacher-forced forward (training, validation, parity tests) -------

    def _dropout(self, x: torch.Tensor, rate: float,
                 gen: Optional[torch.Generator]) -> torch.Tensor:
        """The encoder's and the postnet's dropout after each conv block
        (training only: the identity without a generator)."""
        return dropout(x, rate, gen)

    def _lstm_keep_masks(self, n_steps: int, batch: int, device,
                         gen: Optional[torch.Generator]):
        """Keep masks of the attention and the decoder LSTM's output for
        every teacher-forced step, drawn up front from `gen`:
        [n_steps, batch, dim] bool each, or None at rate 0 or without a
        generator."""
        c = self.config
        out = []
        for rate, dim in ((c.attention_dropout, c.attention_rnn_dim),
                          (c.decoder_dropout, c.decoder_rnn_dim)):
            out.append(None if gen is None or rate == 0.0 else
                       torch.rand((n_steps, batch, dim), generator=gen,
                                  device=device) < 1.0 - rate)
        return out

    def forward(self, tokens, token_lens, mel_tgt, mel_lens, speaker_ids=None,
                *, generator: Optional[torch.Generator] = None):
        """Teacher-forced forward in eval (reference `Tacotron2MS.forward`
        without its training dropouts; the prenet's masks from `generator`,
        a fresh one seeded 0 when None). mel_tgt [B, T_mel, n_mels].
        -> (mel_out, mel_out_postnet, gates, alignments [B, T_mel, T_txt])."""
        return self._teacher_forced(tokens, token_lens, mel_tgt, mel_lens,
                                    speaker_ids, gen=generator, train=False)

    def forward_train(self, tokens, token_lens, mel_tgt, mel_lens,
                      speaker_ids=None, *,
                      gen: Optional[torch.Generator] = None,
                      update_stats: bool = True, stats_sum=None):
        """Teacher-forced forward in training (the JAX `__call__` with
        train=True), float32: dropout 0.5 after every encoder and postnet
        conv block, the prenet's always-on dropout, the attention and
        decoder LSTMs' dropout on every step, BatchNorm on the batch's
        statistics. Every mask is drawn from `gen`, in that order, the
        LSTMs' for all steps up front (None: the prenet's masks from a
        generator seeded 0, no other dropout). With `update_stats` the
        BatchNorm running statistics move (flax's rule,
        `_batch_norm_train`; `stats_sum` takes BatchNorm's statistics over
        the global batch under data parallelism). Returns what `forward`
        returns."""
        return self._teacher_forced(tokens, token_lens, mel_tgt, mel_lens,
                                    speaker_ids, gen=gen, train=True,
                                    update_stats=update_stats,
                                    stats_sum=stats_sum)

    def _teacher_forced(self, tokens, token_lens, mel_tgt, mel_lens,
                        speaker_ids, *, gen, train: bool,
                        update_stats: bool = False, stats_sum=None):
        if train:
            kw = dict(norm=functools.partial(_batch_norm_train,
                                             update=update_stats,
                                             stats_sum=stats_sum),
                      drop=functools.partial(self._dropout,
                                             rate=self.CONV_DROPOUT, gen=gen))
        else:
            kw = {}
        enc = self.encode_infer(tokens, token_lens, speaker_ids, **kw)
        B, T_mel, _ = mel_tgt.shape
        dev = mel_tgt.device
        dec_in = torch.cat([mel_tgt.new_zeros(B, 1, self.config.n_mels),
                            mel_tgt[:, :-1]], dim=1)
        w = self.decoder_weights(mel_tgt.dtype)
        # the prenet is per frame: every step's at once, [T_mel, B, dim]
        masks = self.prenet_masks(T_mel, B, dev, gen)
        pre = self._prenet(dec_in.transpose(0, 1), w,
                           None if masks is None
                           else masks[:T_mel].transpose(0, 1))
        att_keep, dec_keep = (self._lstm_keep_masks(T_mel, B, dev, gen)
                              if train else (None, None))
        state = self.init_decode_carry(enc["memory"])
        mels, gates, aligns = [], [], []
        for t in range(T_mel):
            keep = tuple(None if k is None else k[t]
                         for k in (att_keep, dec_keep))
            state, mel, gate, weights = self._decode_step(state, pre[t], enc,
                                                          w, keep)
            mels.append(mel)
            gates.append(gate)
            aligns.append(weights)
        mel_out = torch.stack(mels, dim=1)
        post = self.postnet(mel_out, mel_lens, **kw)
        return (mel_out, mel_out + post, torch.stack(gates, dim=1),
                torch.stack(aligns, dim=1))

    # ---- the predicated decode ---------------------------------------------

    def init_decode_carry(self, memory: torch.Tensor) -> dict:
        """The decode's carry at step 0: the state, `finished`, `lengths`,
        the global step `t`, the segment step `s` and the run flag `go`
        (set by `start_segment`)."""
        c = self.config
        B, T, _ = memory.shape
        z = lambda *shape: memory.new_zeros(shape)  # noqa: E731
        dev = memory.device
        return {
            "attn_h": z(B, c.attention_rnn_dim),
            "attn_c": z(B, c.attention_rnn_dim),
            "dec_h": z(B, c.decoder_rnn_dim),
            "dec_c": z(B, c.decoder_rnn_dim),
            "attn_weights": z(B, T),
            "attn_weights_cum": z(B, T),
            "attn_context": z(B, c.memory_dim),
            "prev_frame": z(B, c.n_mels),
            "finished": torch.zeros(B, dtype=torch.bool, device=dev),
            "lengths": torch.zeros(B, dtype=torch.int32, device=dev),
            "t": torch.zeros(1, dtype=torch.long, device=dev),
            "s": torch.zeros(1, dtype=torch.long, device=dev),
            "go": torch.zeros(1, dtype=torch.bool, device=dev),
        }

    def decode_buffers(self, memory: torch.Tensor, n_steps: int) -> dict:
        """Zeroed mel, gate and align buffers of n_steps + 1 frames: frame
        s is written at segment step s, and a predicated step past the
        limit writes zeros into the spare last frame."""
        B, T, _ = memory.shape
        return {"mel": memory.new_zeros(B, n_steps + 1, self.config.n_mels),
                "gate": memory.new_zeros(B, n_steps + 1),
                "align": memory.new_zeros(B, n_steps + 1, T)}

    def _run_flag(self, s, limit, finished):
        go = s < limit
        if self.config.decoder_early_stopping:
            go = go & ~finished.all()
        return go

    def start_segment(self, carry: dict, limit: torch.Tensor) -> None:
        """Set s to 0 and the run flag for a segment of `limit` steps
        (a [1] int64 device tensor), in place."""
        carry["s"].zero_()
        carry["go"].copy_(self._run_flag(carry["s"], limit,
                                         carry["finished"]))

    def _predicated_step(self, c: dict, enc: dict, bufs: dict, w: dict,
                         masks: Optional[torch.Tensor], limit) -> dict:
        """One decoder step whose every write is masked by the run flag:
        with go false it leaves the carry and the buffers as they are
        (a buffer frame it writes is the zero frame at index s, not yet
        written). The JAX loop body, predicated."""
        go, t, s = c["go"], c["t"], c["s"]
        pre = self._prenet(c["prev_frame"], w,
                           None if masks is None
                           else masks.index_select(0, t)[0])
        state, mel_frame, gate, weights = self._decode_step(c, pre, enc, w)
        active = ~c["finished"] & go
        act = active[:, None]
        bufs["mel"].index_copy_(
            1, s, torch.where(act, mel_frame, 0.0)[:, None])
        bufs["gate"].index_copy_(1, s, torch.where(go, gate, 0.0)[:, None])
        bufs["align"].index_copy_(
            1, s, torch.where(act, weights, 0.0)[:, None])
        finished = c["finished"] | (
            (torch.sigmoid(gate) > self.config.gate_threshold) & go)
        new = {k: torch.where(go, state[k], c[k]) for k in STATE_KEYS}
        new.update(
            finished=finished,
            lengths=c["lengths"] + active.to(torch.int32),
            t=t + go.long(), s=s + go.long())
        new["go"] = self._run_flag(new["s"], limit, finished)
        return new

    def decode_block(self, carry: dict, enc: dict, bufs: dict,
                     masks: Optional[torch.Tensor],
                     limit: torch.Tensor) -> None:
        """DECODE_BLOCK predicated steps from `carry`, which is updated in
        place (the buffers too). Inputs and outputs are the tensors given,
        so a CUDA graph can record one block and replay it."""
        w = self.decoder_weights(enc["memory"].dtype)
        c = dict(carry)
        for _ in range(DECODE_BLOCK):
            c = self._predicated_step(c, enc, bufs, w, masks, limit)
        for key, val in carry.items():
            val.copy_(c[key])

    def run_segment(self, carry: dict, enc: dict, bufs: dict,
                    masks: Optional[torch.Tensor], limit: torch.Tensor,
                    block: Optional[Callable[[], None]] = None) -> int:
        """Blocks until the run flag drops: the host reads it once per
        block. `block` replaces the eager block (a CUDA graph's replay of
        it on these very tensors). Returns the number of blocks run."""
        self.start_segment(carry, limit)
        if block is None:
            block = lambda: self.decode_block(  # noqa: E731
                carry, enc, bufs, masks, limit)
        n = 0
        while True:
            block()
            n += 1
            if not bool(carry["go"]):
                return n

    # ---- autoregressive inference ------------------------------------------

    def infer(self, tokens, token_lens=None, speaker_ids=None, *,
              max_steps: Optional[int] = None,
              generator: Optional[torch.Generator] = None,
              dtype: torch.dtype = torch.float32, runner=None) -> dict:
        """Autoregressive decode (reference `Tacotron2MS.infer`; the JAX
        `infer`): per-row length bookkeeping, stop when sigmoid(gate) >
        threshold for every row (early stopping) or at `max_steps`.

        Returns dict: mel [B, max_steps, n_mels] (zeros past each length),
        mel_postnet, mel_lens [B] int32, alignments [B, max_steps, T_txt],
        gates [B, max_steps], in `dtype`. `runner`: as in
        `decode_segment`, returning the blocks it ran.

        Spans (`runtime.profiling`): `tts.encode`, and `tts.decode` around
        the blocks and the postnet, counting `decode_steps` (the blocks
        run x DECODE_BLOCK, known on the host without a device read),
        `rows` and `text_len` (the padded batch's shape)."""
        B, T_txt = tokens.shape
        dev = tokens.device
        if token_lens is None:
            token_lens = torch.full((B,), T_txt, dtype=torch.int32)
        max_steps = max_steps or self.config.decoder_max_step
        with span("tts.encode", device=dev):
            enc = self.encode_infer(tokens, token_lens, speaker_ids,
                                    dtype=dtype)
        with span("tts.decode", device=dev):
            carry = self.init_decode_carry(enc["memory"])
            bufs = self.decode_buffers(enc["memory"], max_steps)
            masks = self.prenet_masks(max_steps, B, dev, generator)
            limit = torch.full((1,), max_steps, dtype=torch.long, device=dev)
            blocks = (runner or self.run_segment)(carry, enc, bufs, masks,
                                                  limit)
            if enabled() and blocks is not None:
                count(decode_steps=blocks * DECODE_BLOCK, rows=B,
                      text_len=T_txt)
            return self.finish_infer(bufs, carry["lengths"], max_steps)

    def finish_infer(self, bufs: dict, lengths: torch.Tensor,
                     max_steps: int) -> dict:
        mel = bufs["mel"][:, :max_steps]
        return {
            "mel": mel,
            "mel_postnet": mel + self.postnet(mel, lengths),
            "mel_lens": lengths.clone(),
            "alignments": bufs["align"][:, :max_steps],
            "gates": bufs["gate"][:, :max_steps],
        }

    # ---- segmented decode (streaming) ----------------------------------------

    def decode_segment(self, carry: dict, enc: dict,
                       masks: Optional[torch.Tensor], *, n_steps: int,
                       runner=None):
        """Up to `n_steps` decoder steps from `carry`, early-exiting when
        every row's gate has fired (JAX `decode_segment`). Each step is
        `infer`'s step, its prenet mask indexed by the global step `t`, so
        concatenated segments equal one `infer`.

        `runner(carry, enc, bufs, masks, limit)`, when given, runs the
        segment in place of `run_segment` (the pipeline's CUDA-graph
        replay of the same blocks). Returns (carry', {mel [B, n_steps,
        n_mels] (pre-postnet; zeros past the new frames), gate, align,
        n_new [1] int64})."""
        carry = {k: v.clone() for k, v in carry.items()}
        bufs = self.decode_buffers(enc["memory"], n_steps)
        limit = torch.full((1,), n_steps, dtype=torch.long,
                           device=enc["memory"].device)
        (runner or self.run_segment)(carry, enc, bufs, masks, limit)
        seg = {k: v[:, :n_steps] for k, v in bufs.items()}
        seg["n_new"] = carry["s"].clone()
        return carry, seg
