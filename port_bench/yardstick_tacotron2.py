"""The benchmark's own Tacotron2 arithmetic, frozen here so that no later
change to the program moves the yardstick: the analytic FLOP count of one
utterance (a copy of the port's `eval/flops.py::tacotron2_flops`, on the
configuration's `tacotron2` dict) and the least time of one decode step.
`tests/test_port_bench_tacotron2_arith.py` holds the count equal to the
program's function.

FLOPs count a multiply-add as 2, matmul and conv terms only.
"""
from __future__ import annotations

from port_bench.yardstick import ELEMENT_BYTES, PEAK_BYTES, PEAK_FLOPS


def _memory_dim(cfg: dict) -> int:
    extra = cfg["speaker_embedding_dim"] if cfg["num_speakers"] > 1 else 0
    return cfg["encoder_embedding_dim"] + extra


def decode_step_flops(cfg: dict, n_tokens: int) -> int:
    """One decoder step of one row over `n_tokens` of memory: prenet, the
    attention LSTM, the query, the location conv and its projection, the
    energies, the context, the decoder LSTM, the mel and gate
    projections."""
    T, mem = n_tokens, _memory_dim(cfg)
    ah, a, d = (cfg["attention_hidden_dim"], cfg["attention_rnn_dim"],
                cfg["decoder_rnn_dim"])
    step = 2 * (cfg["n_mels"] * cfg["prenet_dim"]
                + cfg["prenet_dim"] * cfg["prenet_dim"])
    step += 2 * (cfg["prenet_dim"] + mem + a) * 4 * a
    step += 2 * a * ah
    step += 2 * T * (cfg["attention_location_kernel_size"] * 2
                     * cfg["attention_location_n_filters"]
                     + cfg["attention_location_n_filters"] * ah
                     + ah + mem)
    step += 2 * (a + mem + d) * 4 * d
    step += 2 * (d + mem) * (cfg["n_mels"] + 1)
    return step


def tacotron2_flops(cfg: dict, n_tokens: int, n_steps: int) -> int:
    """Encoder, `n_steps` decoder steps and the postnet over them, one row
    of `n_tokens`."""
    T, S = n_tokens, n_steps
    e = cfg["encoder_embedding_dim"]
    f = cfg["encoder_n_convolutions"] * 2 * T * cfg["encoder_kernel_size"] \
        * e * e
    f += 2 * 2 * T * (e + e // 2) * 4 * (e // 2)
    f += 2 * T * _memory_dim(cfg) * cfg["attention_hidden_dim"]
    f += S * decode_step_flops(cfg, T)
    p, k = cfg["postnet_embedding_dim"], cfg["postnet_kernel_size"]
    f += 2 * S * k * (cfg["n_mels"] * p
                      + (cfg["postnet_n_convolutions"] - 2) * p * p
                      + p * cfg["n_mels"])
    return f


def decoder_weight_count(cfg: dict) -> int:
    """The weights one decoder step reads: prenet, both LSTM cells (their
    two biases), query, v, location conv and projection, the mel and gate
    projections."""
    mem = _memory_dim(cfg)
    ah, a, d = (cfg["attention_hidden_dim"], cfg["attention_rnn_dim"],
                cfg["decoder_rnn_dim"])
    n = cfg["n_mels"] * cfg["prenet_dim"] + cfg["prenet_dim"] ** 2
    n += 4 * a * (cfg["prenet_dim"] + mem + a + 2)
    n += ah * a + ah
    n += cfg["attention_location_n_filters"] * (
        2 * cfg["attention_location_kernel_size"] + ah)
    n += 4 * d * (a + mem + d + 2)
    n += (cfg["n_mels"] + 1) * (d + mem + 1)
    return n


def decode_step_bound_s(cfg: dict, batch: int, text_len: int,
                        dtype: str) -> float:
    """The least time (s) of one decode step of `batch` rows over memory
    of `text_len` positions in `dtype`: the larger of the bytes at the
    memory rate (the decoder's weights, the memory and its attention keys
    read once; the state, the previous frame and the attention weights and
    their sum read and written once; the mel frame, gate and alignment
    row written) and the FLOPs at the dtype's dense peak."""
    esize = ELEMENT_BYTES[dtype]
    mem = _memory_dim(cfg)
    a, d = cfg["attention_rnn_dim"], cfg["decoder_rnn_dim"]
    state = 2 * a + 2 * d + mem + cfg["n_mels"] + 2 * text_len
    nbytes = esize * (
        decoder_weight_count(cfg)
        + batch * text_len * (mem + cfg["attention_hidden_dim"])
        + 2 * batch * state
        + batch * (cfg["n_mels"] + 1 + text_len))
    flops = batch * decode_step_flops(cfg, text_len)
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype])
