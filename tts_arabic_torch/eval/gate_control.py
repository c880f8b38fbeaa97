"""Gate-controlled synthetic Tacotron2 checkpoints (the port's counterpart
of the JAX package's `eval/gate_control.py`).

With random weights the decode gate never fires (its logits sit far below
the threshold), so every decode runs to the step cap and never takes the
paths a real checkpoint takes: the EOS stop, ragged per-row lengths, and
the truncated collection that feeds the vocoder (reference gate semantics:
`tacotron2_ms.py:278-332`).

`install_gate_control` rewires a randomly initialised model so that each
utterance's gate fires at a deterministic step near a chosen target, while
the control channel provably leaves the mel and attention trajectories as
they are:

1. the speaker embedding's path into every decode input is cut (its
   columns of `memory_layer`, of both LSTM cells' `weight_ih` and of
   `linear_projection`: the port keeps the reference state-dict layout
   [out, in], so the JAX package's rows are columns here), except for one
   dither channel `j_dyn`, whose gate-weight entry is zeroed instead. Two
   knobs per utterance remain: the gate channel `j_gate` reaches only the
   gate logit (a constant offset `delta`, so the stop step is monotone in
   it), and the dither channel reaches only the dynamics, re-rolling the
   whole gate trajectory.
2. For a fixed dither the live logit is g(t) + delta, so the reachable
   stop steps are the strict prefix-maximum records of g(t). Each dither
   candidate is probed once (a batched decode that never stops early), its
   records are read off, and each utterance keeps the dither whose record
   lands nearest its target.
3. The gate weight is scaled by a power of two (exact in bf16) to give the
   trajectory's wander a usable span and biased so that delta = 0 never
   fires; then each utterance's delta is found by a parallel bisection
   against the live decode, the very program `tts()` runs (the decode-block
   CUDA graphs where they were captured).

Every rewrite is an in-place `copy_` into the module's parameters under
`torch.no_grad()`: no parameter is rebound, so the decoder's per-call
weight casts and the captured decode-block graphs, which read the
parameters' storage, see it.

The calibration is cached on disk (`build/gate_cache/` in the checkout, or
`$TTS_ARABIC_TORCH_GATE_CACHE`), keyed by the texts, targets, a fingerprint
of the pristine weights, the device, the dtype, the step cap and the code
version. A hit replays the stored rewiring and checks it with one live
decode. The install is idempotent: the pristine parameters it mutates are
kept on the pipeline at the first install and restored before every
other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["decode_in_tts_order", "install_gate_control",
           "replay_gate_control"]

# frames a token a trained model emits (the reference corpus's mean)
_FRAMES_PER_TOKEN = 6.5

# bump to drop stale disk caches when the algorithm changes
_CACHE_VERSION = 1

_SNAP_ATTR = "_gate_control_pristine"

# per-utterance dynamics dithers probed per calibration: 0.0 first (the
# undithered trajectory), then magnitudes of the model's own activation
# scale of both signs (the j_dyn columns keep their pristine values)
_DEFAULT_DITHERS = (0.0, 0.7, -0.7, 1.2, -1.2, 2.0, -2.0, 3.5, -3.5,
                    6.0, -6.0, 10.0, -10.0)

# the parameters the rewiring writes, by state-dict name
_MEMORY = "decoder.attention_layer.memory_layer.linear_layer.weight"
_ATTN_IH = "decoder.attention_rnn.weight_ih"
_DEC_IH = "decoder.decoder_rnn.weight_ih"
_PROJ = "decoder.linear_projection.linear_layer.weight"
_SPEAKER = "speaker_embedding.weight"
_GATE_W = "decoder.gate_layer.linear_layer.weight"
_GATE_B = "decoder.gate_layer.linear_layer.bias"
_LEAVES = (_MEMORY, _ATTN_IH, _DEC_IH, _PROJ, _SPEAKER, _GATE_W, _GATE_B)


def _zero_cols(w: np.ndarray, lo: int, hi: int, keep: int) -> np.ndarray:
    """Columns [lo, hi) zeroed, all but column lo + keep."""
    out = w.copy()
    out[:, lo:hi] = 0.0
    out[:, lo + keep] = w[:, lo + keep]
    return out


def _records(sig_row: np.ndarray, floor: int, cap: int) -> np.ndarray:
    """The strict prefix-maximum record steps of one gate trajectory in
    [floor, cap): exactly the steps a constant offset can stop it at (the
    stop is the first t with sig(t) above the threshold)."""
    prefmax = np.maximum.accumulate(sig_row)
    t = np.arange(1, len(sig_row))
    rec = t[sig_row[1:] > prefmax[:-1]]
    return rec[(rec >= floor) & (rec < cap)]


def _params_fingerprint(snapshot: dict) -> str:
    """A stable hash of the pristine weights the install mutates."""
    h = hashlib.sha1()
    for key in sorted(snapshot):
        h.update(np.ascontiguousarray(snapshot[key], np.float32).tobytes())
    return h.hexdigest()[:16]


def _cache_dir() -> pathlib.Path:
    d = os.environ.get("TTS_ARABIC_TORCH_GATE_CACHE")
    if d:
        return pathlib.Path(d)
    return pathlib.Path(__file__).resolve().parents[2] / "build" / "gate_cache"


def _device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class _Rewire:
    """The parameters the install mutates: kept at the first install,
    restored before every other, so a second install is exact."""

    @staticmethod
    def params(pipe) -> dict:
        return dict(pipe.model.model.named_parameters())

    @classmethod
    def snapshot(cls, pipe) -> dict:
        if getattr(pipe, _SNAP_ATTR, None) is None:
            p = cls.params(pipe)
            setattr(pipe, _SNAP_ATTR, {
                k: p[k].detach().float().cpu().numpy().copy()
                for k in _LEAVES})
        return getattr(pipe, _SNAP_ATTR)

    @classmethod
    def restore(cls, pipe) -> None:
        snap = getattr(pipe, _SNAP_ATTR, None)
        if snap is not None:
            p = cls.params(pipe)
            for k, v in snap.items():
                _write(p[k], v)


def _write(param: torch.nn.Parameter, value: np.ndarray) -> None:
    with torch.no_grad():
        param.copy_(torch.from_numpy(
            np.ascontiguousarray(value, np.float32)).reshape(param.shape))


def decode_in_tts_order(model, texts: Sequence[str], speakers,
                        postprocess_mel: bool = False) -> dict:
    """One batched decode of `texts` as `tts(texts, batch_size=len(texts),
    speaker_id=speakers, postprocess_mel=...)` decodes them (its length
    sort of the texts, then the decode's sort by token count, with the
    same prenet masks) -> the decode's outputs on the device, rows back in
    the texts' order. `model` is the pipeline's `Tacotron2TTS`."""
    order = sorted(range(len(texts)), key=lambda i: -len(texts[i]))
    tokens, _ = model._prepare_tokens([texts[i] for i in order], None,
                                      postprocess_mel)
    out, _, inverse = model._dispatch_infer(
        tokens, np.asarray(speakers)[order], pad_to=len(texts))
    rows = inverse[np.argsort(order)]
    return {k: v[torch.from_numpy(rows).to(v.device)]
            for k, v in out.items()}


class _Control:
    """One calibration's model, texts and decodes. The texts are decoded
    as `tts(texts, batch_size=len(texts))` decodes them
    (`decode_in_tts_order`), so the lengths found here are the ones tts()
    realizes."""

    def __init__(self, pipe, texts, postprocess_mel: bool,
                 speaker_base: int):
        m = self.m = pipe.model
        self.net = m.model
        cfg = self.cfg = self.net.config
        self.B = B = len(texts)
        if cfg.num_speakers < speaker_base + B:
            raise ValueError(f"need num_speakers >= {speaker_base + B}, "
                             f"got {cfg.num_speakers}")
        self.speaker_base = speaker_base
        self.snapshot = _Rewire.snapshot(pipe)
        _Rewire.restore(pipe)
        self.p = _Rewire.params(pipe)
        self.spk = np.arange(speaker_base, speaker_base + B)
        self.texts, self.postprocess_mel = list(texts), postprocess_mel

        d_enc, d_spk = cfg.encoder_embedding_dim, cfg.speaker_embedding_dim
        self.d_enc, self.d_spk = d_enc, d_spk
        self.mem = d_enc + d_spk
        drnn = self.drnn = cfg.decoder_rnn_dim
        # channel picks from the pristine gate weight: the largest |entry|
        # among its speaker inputs is the gate channel, the second the
        # dither channel
        gw = self.snapshot[_GATE_W][0]
        order = np.argsort(-np.abs(gw[drnn + d_enc: drnn + self.mem]))
        self.j_gate, self.j_dyn = int(order[0]), int(order[1])

    def cut(self) -> np.ndarray:
        """Step 1: cut every speaker path into the dynamics but j_dyn's,
        and j_dyn's path into the gate. Returns the cut gate weight row."""
        c, snap, j = self.cfg, self.snapshot, self.j_dyn
        d_enc, mem, drnn = self.d_enc, self.mem, self.drnn
        for name, lo in ((_MEMORY, 0), (_ATTN_IH, c.prenet_dim),
                         (_DEC_IH, c.attention_rnn_dim), (_PROJ, drnn)):
            _write(self.p[name],
                   _zero_cols(snap[name], lo + d_enc, lo + mem, keep=j))
        gw = snap[_GATE_W][0].copy()
        gw[drnn + d_enc + j] = 0.0
        _write(self.p[_GATE_W], gw[None])
        _write(self.p[_SPEAKER], np.zeros_like(snap[_SPEAKER]))
        return gw

    def set_gate(self, gw: np.ndarray, amp: float,
                 bias: Optional[float] = None) -> None:
        _write(self.p[_GATE_W], (gw * amp)[None])
        if bias is not None:
            _write(self.p[_GATE_B], np.asarray([bias]))

    def set_embedding(self, dithers, deltas, w_b: float) -> None:
        emb = np.zeros((self.cfg.num_speakers, self.d_spk), np.float32)
        rows = slice(self.speaker_base, self.speaker_base + self.B)
        emb[rows, self.j_dyn] = dithers
        emb[rows, self.j_gate] = np.asarray(deltas) / w_b
        _write(self.p[_SPEAKER], emb)

    def decode(self, field: str) -> np.ndarray:
        """One batched decode of the texts -> `field` of its outputs, rows
        in the texts' order."""
        out = decode_in_tts_order(self.m, self.texts, self.spk,
                                  self.postprocess_mel)
        return out[field].float().cpu().numpy()

    def lengths(self) -> np.ndarray:
        return self.decode("mel_lens").astype(np.int64)

    def probe(self, dither: float) -> np.ndarray:
        """The gate logits of every step [B, cap] of a decode with this
        dither and no gate offset, decoded with early stopping off (so
        under a decode-block graph key of its own: a graph recorded with
        early stopping would stop the probe short and cut its gate
        buffers)."""
        self.set_embedding(np.full(self.B, dither), np.zeros(self.B), 1.0)
        net, cfg = self.net, self.cfg
        net.config = dataclasses.replace(cfg, decoder_early_stopping=False)
        try:
            return self.decode("gates")
        finally:
            net.config = cfg

    def replay(self, gw: np.ndarray, rewiring: dict) -> np.ndarray:
        """A stored calibration's gate scale, bias and embedding installed
        on the cut model -> the lengths the live decode realizes."""
        self.set_gate(gw, rewiring["amp"], rewiring["bias"])
        self.set_embedding(np.asarray(rewiring["dithers"], np.float32),
                           np.asarray(rewiring["deltas"], np.float64),
                           rewiring["w_b"])
        return self.lengths()


def replay_gate_control(pipe, texts: Sequence[str], rewiring: dict, *,
                        postprocess_mel: bool = False,
                        speaker_base: int = 0):
    """Install a calibration found elsewhere (`rewiring`: `amp`, `bias`,
    `w_b`, `dithers`, `deltas`, as a cache file of either package stores
    them) on `pipe`'s pristine weights. Returns (speakers, the lengths the
    live decode of `texts` realizes)."""
    ctl = _Control(pipe, texts, postprocess_mel, speaker_base)
    return ctl.spk, ctl.replay(ctl.cut(), rewiring)


def install_gate_control(
    pipe,
    texts: Sequence[str],
    targets: Optional[Sequence[int]] = None,
    *,
    postprocess_mel: bool = False,
    target_span: float = 16.0,
    base_gap: float = 4.0,
    t_min: int = 16,
    min_len: Optional[int] = None,
    speaker_base: int = 0,
    search_iters: int = 24,
    dither_candidates: Sequence[float] = _DEFAULT_DITHERS,
    use_cache: bool = True,
):
    """Rewire `pipe` (a `Tacotron2Wave`) for controlled gate stops.

    Mutates the model's parameters in place (idempotent: a second install
    restores the pristine weights first) and runs its calibration decodes
    of `texts` as `pipe.tts(texts, batch_size=len(texts), speaker_id=
    speakers, postprocess_mel=...)` decodes them: the same tokens, order,
    prenet masks and decode graphs.

    `min_len` floors both the automatic targets and the accepted stops
    (86 frames is about 1 s of audio); it defaults to `t_min`.

    Returns (speakers, lengths, report): `speakers` to pass as
    `tts(..., speaker_id=speakers)` (speaker i = speaker_base + i);
    `lengths`, the decode length each utterance realizes (`mel_lens`: the
    stop step + 1, or `decoder_max_step` where the gate never fires), from
    the final live decode; `report`, the targets, realized lengths,
    off-target and cap counts, the chosen dithers, the channels and the
    cache status. The config needs `num_speakers >= speaker_base +
    len(texts)`."""
    ctl = _Control(pipe, texts, postprocess_mel, speaker_base)
    m, B = ctl.m, ctl.B
    max_steps = m.decoder_max_step
    floor = int(min_len if min_len is not None else t_min)
    if targets is None:
        tok_lens = [len(m.tokenize(t)) for t in texts]
        targets = np.clip(
            (_FRAMES_PER_TOKEN * np.asarray(tok_lens)).astype(int),
            max(t_min + 8, floor), max_steps - 16)
    targets = np.asarray(targets, int)
    gw = ctl.cut()

    # ---- disk cache: replay an earlier calibration if it still holds
    dev = pipe.device
    key_payload = json.dumps({
        "v": _CACHE_VERSION, "texts": list(texts),
        "targets": targets.tolist(), "pp": postprocess_mel,
        "span": target_span, "gap": base_gap, "t_min": t_min,
        "floor": floor, "base": speaker_base, "iters": search_iters,
        "dithers": [float(d) for d in dither_candidates],
        "max_steps": max_steps,
        "params": _params_fingerprint(ctl.snapshot),
        "platform": dev.type, "device_kind": _device_kind(dev),
        "dtype": str(m.dtype),
    }, sort_keys=True)
    cache_file = _cache_dir() / (
        hashlib.sha1(key_payload.encode()).hexdigest()[:24] + ".json")
    if use_cache and cache_file.exists():
        try:
            c = json.loads(cache_file.read_text())
        except (OSError, ValueError):
            c = None
        if c is not None and ctl.replay(gw, c).tolist() == c["lengths"]:
            report = dict(c["report"], cache="hit")
            return ctl.spk, np.asarray(c["lengths"]), report
        # stale (other numerics): calibrate again

    # 2a. one probe decode per dither at the natural gate scale: the gate
    # feeds back into nothing (it only stops the loop), so scaling and
    # biasing it afterwards moves these same trajectories exactly
    b0 = float(ctl.snapshot[_GATE_B][0])
    sigs = np.stack([ctl.probe(d) - b0 for d in dither_candidates])

    # per utterance: the dither whose record set lands nearest its target
    chosen = np.zeros(B, int)
    predicted_gap = np.full(B, np.inf)
    for i in range(B):
        for k in range(len(dither_candidates)):
            rec = _records(sigs[k, i], floor, max_steps)
            if len(rec):
                gap_k = np.abs(rec - targets[i]).min()
                if gap_k < predicted_gap[i]:
                    predicted_gap[i] = gap_k
                    chosen[i] = k
    dithers = np.asarray([dither_candidates[k] for k in chosen], np.float32)
    sig = sigs[chosen, np.arange(B)]

    # the span from the wander after the onset transient, scaled by a
    # power of two (exact in bf16) to target_span
    std = max(float(sig[:, t_min:].std()), 1e-9)
    amp = float(2.0 ** np.round(np.log2(target_span / std)))
    ctl.set_gate(gw, amp)
    w_b = float(gw[ctl.drnn + ctl.d_enc + ctl.j_gate] * amp)

    # 2b. a never-firing base bias on the live program: the probe only
    # estimates the maximum (another program need not replay it exactly),
    # so back off until delta = 0 decodes every row to the cap
    gap = base_gap
    for _ in range(4):
        bias = -amp * float(sig.max()) - gap
        ctl.set_gate(gw, amp, bias)
        ctl.set_embedding(dithers, np.zeros(B), w_b)
        if int(ctl.lengths().min()) >= max_steps:
            break
        gap *= 4.0
    else:
        raise RuntimeError("gate_control: could not find a never-firing "
                           "base bias")
    bias = float(ctl.p[_GATE_B].detach().float().cpu()[0])

    # 3. per-utterance parallel bisection of delta against the live
    # decode: for a fixed dither the trajectory does not depend on delta,
    # so the brackets never lie; keep the evaluation nearest the target
    # among acceptable stops (fired in [floor, cap))
    lo = np.zeros(B)
    hi = np.full(B, np.nan)
    trial = np.full(B, gap + 2.0 * target_span)
    best_delta = np.zeros(B)
    best_len = np.full(B, max_steps, np.int64)
    for _ in range(search_iters):
        ctl.set_embedding(dithers, trial, w_b)
        realized = ctl.lengths()
        fired = (realized < max_steps) & (realized >= floor)
        better = fired & ((best_len >= max_steps)
                          | (np.abs(realized - targets)
                             < np.abs(best_len - targets)))
        best_delta[better] = trial[better]
        best_len[better] = realized[better]
        high = realized > targets
        lo = np.where(high, trial, lo)
        hi = np.where(high, hi, np.where(np.isnan(hi), trial,
                                         np.minimum(hi, trial)))
        trial = np.where(np.isnan(hi), trial * 4.0, 0.5 * (lo + hi))

    # the step cap is a real decode outcome (the reference's
    # decoder_max_step truncation): where no reachable stop is nearer the
    # target than the cap, keep delta = 0 and decode to the cap
    cap_closer = (np.abs(np.int64(max_steps) - targets)
                  < np.abs(best_len - targets))
    best_delta = np.where(cap_closer, 0.0, best_delta)

    ctl.set_embedding(dithers, best_delta, w_b)
    lengths = ctl.lengths()
    at_cap = lengths >= max_steps
    within = np.abs(lengths - targets) <= 0.25 * targets
    report = {
        "targets": targets.tolist(),
        "realized_lengths": lengths.tolist(),
        "off_target": int((~within).sum()),
        "n_fired": int((~at_cap).sum()),
        "cap_preferred": int((at_cap & within).sum()),
        "cap_fallback": int((at_cap & ~within).sum()),
        "predicted_gap_rel": np.round(
            np.where(np.isfinite(predicted_gap),
                     predicted_gap / targets, -1.0), 3).tolist(),
        "amplify": amp,
        "gap": gap,
        "gate_channel": ctl.j_gate,
        "dither_channel": ctl.j_dyn,
        "dithers": dithers.tolist(),
        "floor": floor,
        "cache": "miss",
    }
    if use_cache:
        try:
            cache_file.parent.mkdir(parents=True, exist_ok=True)
            cache_file.write_text(json.dumps({
                "amp": amp, "bias": bias, "w_b": w_b,
                "dithers": dithers.tolist(),
                "deltas": best_delta.tolist(),
                "lengths": lengths.tolist(),
                "report": report, "key": json.loads(key_payload),
            }, indent=1))
        except OSError:
            pass
    return ctl.spk, lengths, report
