"""The Tacotron2 decoder's predicated inference step as hand-written CUDA
kernels, with its plain version.

Replaces no TPU kernel: the JAX package leaves the step to XLA. Added for
the card's decode, whose step ran as some 70 small ATen, cuBLAS and cuDNN
launches inside the decode-block graph. Source: `csrc/tacotron2_step.cu`,
five launches a step (prenet; attention LSTM; location-sensitive attention
in thread-block clusters; decoder LSTM; projection with the bookkeeping),
whose note gives the design and what bounds it (the decoder's weights, read
once a step).

`decode_steps` runs a block's predicated steps in place on the carry and
the buffers. On CPU tensors it runs the plain version, today's
`Tacotron2._predicated_step` loop, unchanged. On CUDA tensors it launches
the kernels, or raises; nothing falls back. While `torch.export` traces, it
goes through the custom op `tts_arabic::tacotron2_step` (the Tacotron2
bundles of `apps.export_serving` trace `decode_block` into it), whose CPU
body is the plain loop; an eager call on the card launches directly, since
the mutating op's first call imports PyTorch's functionalization (seconds
of a process's start). The kernels are inference only: training keeps the
eager `_decode_step` and its dropouts.

The kernels read the weights they are given at each launch (and a CUDA
graph the tensors it recorded): `decode_block` casts and packs the module's
parameters once a block, inside the graph, so an in-place `copy_` into a
parameter (gate control) reaches the next replay.

Two counts show that a decode went through the kernels.
`LAUNCHES["tacotron2_step"]` counts the fused steps the host launched
(eagerly, or into a CUDA graph it recorded). `device_runs` reads the counts
the kernels keep on the card: each kernel adds one when it starts, so the
steps of a replayed graph count too (`RUNS`: a step's five kernels, then a
block's two).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

# fused steps the host launched, eagerly or into a graph it recorded
# (plain-version steps are not counted)
LAUNCHES = {"tacotron2_step": 0}

# the kernels whose runs the card counts (csrc/tacotron2_step.cu enum Run):
# a step's five, then a block's weight preparation and bf16 pack
RUNS = ("prenet", "attention_lstm", "attention", "decoder_lstm", "out",
        "att_prep", "pack")
KERNELS_PER_STEP = 5

STATE = ("attn_h", "attn_c", "dec_h", "dec_c", "attn_weights",
         "attn_weights_cum", "attn_context", "prev_frame")
BOOKS = ("finished", "lengths", "t", "s", "go")
CARRY = STATE + BOOKS
ENC = ("memory", "processed_memory", "memory_mask")
BUFS = ("mel", "gate", "align")
WEIGHTS = ("prenet0", "prenet1", "att_w_ih", "att_w_hh", "att_b_ih",
           "att_b_hh", "dec_w_ih", "dec_w_hh", "dec_b_ih", "dec_b_hh",
           "query", "v", "location_conv", "location_dense", "out_w",
           "out_b")
# the kernels' pointer table (csrc/tacotron2_step.cu enum Ptr), then the
# scratch they write
_PTRS = CARRY + ENC + BUFS + WEIGHTS + ("masks", "limit")
_SCRATCH = ("pre", "attn_h", "attn_c", "dec_h", "dec_c", "attn_weights",
            "attn_weights_cum", "attn_context")


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def device_runs(where) -> Optional[torch.Tensor]:
    """The card's counts of the kernels' runs since the library was loaded
    (int64 [len(RUNS)], in RUNS' order) on the device of `where` (a tensor
    or a device), copied on its current stream, so they hold every kernel
    queued there before; None off the card. Reading them (`steps_since`,
    `.tolist()`) waits for the stream."""
    t = (where if isinstance(where, torch.Tensor)
         else torch.empty(0, device=where))
    if not _on_card(t):
        return None
    from .build import library
    lib = library()
    out = torch.empty(len(RUNS), dtype=torch.int64, device=t.device)
    err = lib.tacotron2_step_runs(_device_index(t.device), out.data_ptr(),
                                  _stream(t.device))
    if err != 0:
        raise RuntimeError(f"tacotron2_step_runs failed: cudaError {err}")
    return out


def steps_since(before: Optional[torch.Tensor]) -> int:
    """The fused steps the card ran since `device_runs` gave `before` (the
    runs of the step's last kernel); 0 when `before` is None."""
    if before is None:
        return 0
    now = device_runs(before)
    return int(now[RUNS.index("out")] - before[RUNS.index("out")])


def flat_weights(w: dict) -> dict:
    """`Tacotron2.decoder_weights`' dict under the op's argument names."""
    return dict(zip(WEIGHTS, (*w["prenet"], *w["attention_rnn"],
                              *w["decoder_rnn"], w["query"], w["v"],
                              w["location_conv"], w["location_dense"],
                              w["out_w"], w["out_b"])))


def _nested_weights(f: dict) -> dict:
    return {"prenet": [f["prenet0"], f["prenet1"]],
            "attention_rnn": tuple(f[k] for k in WEIGHTS[2:6]),
            "decoder_rnn": tuple(f[k] for k in WEIGHTS[6:10]),
            **{k: f[k] for k in WEIGHTS[10:]}}


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _device_index(device) -> int:
    device = torch.device(device)
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def decode_steps(model, carry: dict, enc: dict, bufs: dict,
                 masks: Optional[torch.Tensor], limit: torch.Tensor,
                 steps: int) -> None:
    """`steps` predicated decoder steps of `model` (a `Tacotron2`) from
    `carry`, in place on the carry and the buffers, the weights cast once
    from the parameters as they are now. CPU tensors run the plain version
    (`Tacotron2._predicated_step`, unchanged); CUDA tensors the kernels;
    any tensors, while `torch.export` traces, the op."""
    dtype = enc["memory"].dtype
    c = model.config
    if torch.compiler.is_exporting():
        tacotron2_step_op(
            *(carry[k] for k in CARRY), *(enc[k] for k in ENC),
            *(bufs[k] for k in BUFS),
            *flat_weights(model.decoder_weights(dtype)).values(), masks,
            limit, steps, c.prenet_dropout, c.gate_threshold,
            c.decoder_early_stopping)
    elif not _on_card(enc["memory"]):
        _plain_steps(model, carry, enc, bufs, model.decoder_weights(dtype),
                     masks, limit, steps)
    else:
        w = (packed_weights(model, dtype) if dtype == torch.bfloat16
             else model.decoder_weights(dtype))
        args = dict(zip(_PTRS, (
            *(carry[k] for k in CARRY), *(enc[k] for k in ENC),
            *(bufs[k] for k in BUFS), *flat_weights(w).values(), masks,
            limit)))
        _check(args)
        _launch(args, steps, c.prenet_dropout, c.gate_threshold,
                c.decoder_early_stopping)


def packed_weights(model, dtype) -> dict:
    """`model.decoder_weights(dtype)` for bf16 on the card, cast by one
    kernel launch (`tacotron2_pack_bf16`) into one buffer: the same values
    (f32 rounded to nearest even), the mel and gate projections adjacent,
    so `out_w` and `out_b` are views. Parameters in another dtype than f32
    go through `decoder_weights`."""
    params = model.decoder_params()
    srcs = [x for p in params.values()
            for x in ((p,) if isinstance(p, torch.Tensor) else p)]
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in srcs):
        return model.decoder_weights(dtype)
    # each projection's gate row right after its mel rows; every other
    # tensor starts on a 16-byte boundary
    gates = {id(params["out_w"][1]), id(params["out_b"][1])}
    offsets, n = [], 0
    for x in srcs:
        if id(x) not in gates:
            n = -(-n // 8) * 8
        offsets.append(n)
        n += x.numel()
    dev = srcs[0].device
    flat = torch.empty(n, dtype=dtype, device=dev)
    from .build import library
    lib = library()
    k = len(srcs)
    err = lib.tacotron2_pack_bf16(
        k, (ctypes.c_longlong * k)(*[x.data_ptr() for x in srcs]),
        (ctypes.c_longlong * k)(*[flat.data_ptr() + 2 * o for o in offsets]),
        (ctypes.c_longlong * k)(*[x.numel() for x in srcs]), _stream(dev))
    if err != 0:
        raise RuntimeError(f"tacotron2_pack_bf16 launch failed: cudaError "
                           f"{err}")

    def view(i, shape):
        return flat[offsets[i]: offsets[i] + math.prod(shape)].view(shape)
    views = [view(i, x.shape) for i, x in enumerate(srcs[:14])]
    mel_w, mel_b = params["out_w"][0], params["out_b"][0]
    return {"prenet": views[:2], "attention_rnn": tuple(views[2:6]),
            "decoder_rnn": tuple(views[6:10]), "query": views[10],
            "v": views[11], "location_conv": views[12],
            "location_dense": views[13],
            "out_w": view(14, (mel_w.shape[0] + 1, mel_w.shape[1])),
            "out_b": view(16, (mel_b.shape[0] + 1,))}


def _plain_steps(model, carry, enc, bufs, w, masks, limit, steps) -> None:
    """The plain version: `steps` of `model._predicated_step`, then the
    carry copied back in place."""
    c = dict(carry)
    for _ in range(steps):
        c = model._predicated_step(c, enc, bufs, w, masks, limit)
    for key, val in carry.items():
        val.copy_(c[key])


class _PlainModel:
    """What `Tacotron2._predicated_step` reads of its model: a config and
    the step's methods, Tacotron2's own (no parameters: the step takes its
    weights as arguments)."""

    def __init__(self, n_mels: int, prenet_dropout: float,
                 gate_threshold: float, early_stopping: bool):
        from ..models.tacotron2 import Tacotron2Config
        self.config = dataclasses.replace(
            Tacotron2Config(), n_mels=n_mels, prenet_dropout=prenet_dropout,
            gate_threshold=gate_threshold,
            decoder_early_stopping=early_stopping)

    def __getattr__(self, name):
        from ..models.tacotron2 import Tacotron2
        return getattr(Tacotron2, name).__get__(self)


@torch.library.custom_op(
    "tts_arabic::tacotron2_step", mutates_args=CARRY + BUFS)
def tacotron2_step_op(
        attn_h: torch.Tensor, attn_c: torch.Tensor, dec_h: torch.Tensor,
        dec_c: torch.Tensor, attn_weights: torch.Tensor,
        attn_weights_cum: torch.Tensor, attn_context: torch.Tensor,
        prev_frame: torch.Tensor, finished: torch.Tensor,
        lengths: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
        go: torch.Tensor, memory: torch.Tensor,
        processed_memory: torch.Tensor, memory_mask: torch.Tensor,
        mel: torch.Tensor, gate: torch.Tensor, align: torch.Tensor,
        prenet0: torch.Tensor, prenet1: torch.Tensor,
        att_w_ih: torch.Tensor, att_w_hh: torch.Tensor,
        att_b_ih: torch.Tensor, att_b_hh: torch.Tensor,
        dec_w_ih: torch.Tensor, dec_w_hh: torch.Tensor,
        dec_b_ih: torch.Tensor, dec_b_hh: torch.Tensor,
        query: torch.Tensor, v: torch.Tensor, location_conv: torch.Tensor,
        location_dense: torch.Tensor, out_w: torch.Tensor,
        out_b: torch.Tensor, masks: Optional[torch.Tensor],
        limit: torch.Tensor, steps: int, prenet_dropout: float,
        gate_threshold: float, early_stopping: bool) -> None:
    """`steps` predicated Tacotron2 decoder steps in place on the carry
    (`CARRY`) and the buffers (`BUFS`): the kernels on a CUDA tensor
    (counted in LAUNCHES), the plain step on a CPU one. The weights are
    `decoder_weights`' in the state's dtype, flattened (`WEIGHTS`)."""
    args = dict(zip(_PTRS, (
        attn_h, attn_c, dec_h, dec_c, attn_weights, attn_weights_cum,
        attn_context, prev_frame, finished, lengths, t, s, go, memory,
        processed_memory, memory_mask, mel, gate, align, prenet0, prenet1,
        att_w_ih, att_w_hh, att_b_ih, att_b_hh, dec_w_ih, dec_w_hh,
        dec_b_ih, dec_b_hh, query, v, location_conv, location_dense, out_w,
        out_b, masks, limit)))
    _check(args)
    if _on_card(memory):
        _launch(args, steps, prenet_dropout, gate_threshold, early_stopping)
        return
    model = _PlainModel(prenet0.shape[1], prenet_dropout, gate_threshold,
                        early_stopping)
    _plain_steps(model, {k: args[k] for k in CARRY},
                 {k: args[k] for k in ENC}, {k: args[k] for k in BUFS},
                 _nested_weights(args), masks, limit, steps)


@tacotron2_step_op.register_fake
def _(*args, **kwargs):
    return None


def _check(a: dict) -> None:
    """Raise on inputs the kernels do not take."""
    mem = a["memory"]
    if mem.dim() != 3:
        raise ValueError(f"memory must be [B, T, M], got {tuple(mem.shape)}")
    dt, dev = mem.dtype, mem.device
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the decode step takes float32 or bfloat16, not {dt}")
    kinds = {"finished": torch.bool, "go": torch.bool, "memory_mask":
             torch.bool, "masks": torch.bool, "lengths": torch.int32,
             "t": torch.int64, "s": torch.int64, "limit": torch.int64}
    for name, x in a.items():
        if x is None:
            if name != "masks":
                raise ValueError(f"{name} is None")
            continue
        want = kinds.get(name, dt)
        if x.dtype != want or x.device != dev or not x.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {want} tensor on {dev}, got "
                f"{x.dtype} on {x.device} contiguous={x.is_contiguous()}")
    B, T, M = mem.shape
    P, n_mels = a["prenet0"].shape
    A, D = a["att_w_hh"].shape[1], a["dec_w_hh"].shape[1]
    AH, F = a["query"].shape[0], a["location_conv"].shape[0]
    shapes = {"attn_h": (B, A), "attn_c": (B, A), "dec_h": (B, D),
              "dec_c": (B, D), "attn_weights": (B, T),
              "attn_weights_cum": (B, T), "attn_context": (B, M),
              "prev_frame": (B, n_mels), "finished": (B,), "lengths": (B,),
              "t": (1,), "s": (1,), "go": (1,), "limit": (1,),
              "processed_memory": (B, T, AH), "memory_mask": (B, T),
              "prenet1": (P, P), "att_w_ih": (4 * A, P + M),
              "att_w_hh": (4 * A, A), "att_b_ih": (4 * A,),
              "att_b_hh": (4 * A,), "dec_w_ih": (4 * D, A + M),
              "dec_w_hh": (4 * D, D), "dec_b_ih": (4 * D,),
              "dec_b_hh": (4 * D,), "query": (AH, A), "v": (1, AH),
              "location_dense": (AH, F), "out_w": (n_mels + 1, D + M),
              "out_b": (n_mels + 1,)}
    for name, want in shapes.items():
        if tuple(a[name].shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{tuple(a[name].shape)}")
    conv = a["location_conv"]
    if conv.dim() != 3 or conv.shape[1] != 2 or conv.shape[2] % 2 != 1:
        raise ValueError(f"location_conv must be [F, 2, odd k], got "
                         f"{tuple(conv.shape)}")
    S1 = a["mel"].shape[1]
    for name, want in (("mel", (B, S1, n_mels)), ("gate", (B, S1)),
                       ("align", (B, S1, T))):
        if tuple(a[name].shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{tuple(a[name].shape)}")
    masks = a["masks"]
    if masks is not None and (masks.dim() != 4
                              or tuple(masks.shape[1:]) != (2, B, P)):
        raise ValueError(f"masks must be [steps + 1, 2, {B}, {P}], got "
                         f"{tuple(masks.shape)}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(a: dict, steps: int, prenet_dropout: float,
            gate_threshold: float, early_stopping: bool) -> None:
    """`steps` fused steps on the kernels: the scratch allocated here (in a
    graph's pool while one is recorded), one C call."""
    from .build import library
    lib = library()
    mem = a["memory"]
    dev, dt = mem.device, mem.dtype
    B, T, M = mem.shape
    P, n_mels = a["prenet0"].shape
    A, D = a["att_w_hh"].shape[1], a["dec_w_hh"].shape[1]
    AH = a["query"].shape[0]
    F, _, KS = a["location_conv"].shape
    odd = {k: v for k, v in (("n_mels", n_mels), ("prenet_dim", P),
                             ("attention_rnn_dim", A), ("decoder_rnn_dim", D),
                             ("memory_dim", M), ("attention_hidden_dim", AH))
           if v % 8}
    if odd:
        raise ValueError(f"the fused step's kernels load rows 8 elements at "
                         f"a time: widths {odd} are no multiples of 8")
    if n_mels > 128 or P > 256 or M > 2048 or AH > 256 or F > 32 or F % 4:
        raise ValueError(
            f"the fused step takes n_mels <= 128, prenet_dim <= 256, "
            f"memory_dim <= 2048, attention_hidden_dim <= 256 and 4 to 32 "
            f"location filters in fours, not {n_mels}, {P}, {M}, {AH} and "
            f"{F}")
    if any(x.data_ptr() % 16 for x in a.values()
           if x is not None and x.is_floating_point()):
        raise ValueError("the fused step's tensors must start on 16-byte "
                         "boundaries")
    widths = {"pre": P, "attn_h": A, "attn_c": A, "dec_h": D, "dec_c": D,
              "attn_weights": T, "attn_weights_cum": T, "attn_context": M}
    scratch = [torch.empty((B, widths[k]), dtype=dt, device=dev)
               for k in _SCRATCH]
    scratch.append(torch.empty((B,), dtype=torch.float32, device=dev))
    # the attention's small weights in f32 (location conv, dense
    # transposed, v), each part padded to 4 floats: csrc att_layout
    scratch.append(torch.empty(
        (-(-2 * F * KS // 4) * 4 + -(-(F * AH + AH) // 4) * 4,),
        dtype=torch.float32, device=dev))
    scratch.append(torch.zeros((1,), dtype=torch.int32, device=dev))
    masks = a["masks"]
    ptrs = [0 if a[k] is None else a[k].data_ptr() for k in _PTRS]
    ptrs += [x.data_ptr() for x in scratch]
    dims = [B, T, n_mels, P, A, D, M, AH, F, KS, a["mel"].shape[1],
            0 if masks is None else masks.shape[0], int(early_stopping)]
    # the plain step compares sigmoid(gate) in the state's dtype with the
    # threshold rounded to it
    threshold = float(torch.tensor(gate_threshold, dtype=dt))
    scalars = [1.0 / (1.0 - prenet_dropout), threshold]
    err = lib.tacotron2_step(
        1 if dt == torch.bfloat16 else 0,
        (ctypes.c_longlong * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims),
        (ctypes.c_float * 2)(*scalars), steps, _stream(dev))
    if err != 0:
        raise RuntimeError(f"tacotron2_step kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["tacotron2_step"] += steps
