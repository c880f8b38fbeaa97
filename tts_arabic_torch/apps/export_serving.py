"""AOT serving bundles: `torch.export` programs with baked weights (the
port's counterpart of the JAX package's `apps/export_serving.py`).

    python -m tts_arabic_torch.apps.export_serving --out bundle/ \
        [--checkpoint <states.ckpt or .pth>] [--model tacotron2] \
        [--batch-sizes 8 --text-buckets 64,128 --mel-buckets 256,768] \
        [--device cpu]

FastPitch: each (batch, text bucket) encode program and each (batch, mel
bucket) wave program (decoder + HiFi-GAN + denoiser + int16, in bf16 with
the encode in f32, as the JAX bundles) is traced with `torch.export` and
saved as a `.pt2` file with the weights baked in as the program's
constants: a serving process needs only the bundle and the text frontend,
no checkpoint and no model-building code. HiFi-GAN's ResBlocks run inside
the wave programs as the custom op `tts_arabic::resblock1` (the CUDA
kernel on the card), their weights in the kernel layout made once at
export. Tacotron2: an encode program, one decode-block program (the
live path's DECODE_BLOCK predicated steps; the host reads the run flag
after each block) and one finish program (postnet + EOS truncation) per
(batch, text bucket), and an assemble + vocode program per (batch, mel
bucket); the prenet's dropout masks are drawn at export from the live
pipeline's default generator (seed 0) and baked in.

A bundle runs on the device it was exported for: the card by default,
the CPU with `--device cpu`. Load it with `ServingBundle(dir)` or
`Tacotron2ServingBundle(dir)`.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import text as text_frontend
from ..runtime.device import resolve_device


def _enc_name(bs: int, tb: int) -> str:
    return f"encode_b{bs}_t{tb}.pt2"


def _wave_name(bs: int, mb: int) -> str:
    return f"wave_b{bs}_m{mb}.pt2"


class _Program(torch.nn.Module):
    """A function as a module for `torch.export`: every tensor it reads
    that is not an argument (the weights) becomes a constant of the
    program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _export(fn, args: tuple, path: pathlib.Path) -> None:
    """Run fn once on real inputs (so that every table a model keeps for
    later calls is made outside the trace), then export and save it."""
    from ..infer.pipeline import _exact_f32
    with _exact_f32():
        fn(*args)
        program = torch.export.export(_Program(fn), args, strict=False)
    # a constant that is a view (a row of a stacked weight, the head of a
    # kept table) is saved as a tensor of its own
    for name, value in program.constants.items():
        if isinstance(value, torch.Tensor):
            program.constants[name] = value.clone()
    torch.export.save(program, path)


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def _bake(vocoder, dtype) -> None:
    from ..vocoder.hifigan import ResBlock1
    for block in vocoder.resblocks:
        if isinstance(block, ResBlock1):
            block.bake(dtype)


def _write_manifest(out: pathlib.Path, **fields) -> None:
    (out / "manifest.json").write_text(json.dumps(
        {"format": 1, **fields}, indent=1))


def export_bundle(out_dir, checkpoint: Optional[str] = None, *,
                  batch_sizes: Sequence[int] = (1,),
                  text_buckets: Sequence[int] = (16, 32, 64),
                  mel_buckets: Sequence[int] = (256, 512, 1024),
                  device=None, seed: int = 0) -> pathlib.Path:
    """Export FastPitch + HiFi-GAN encode/wave programs for every
    signature; returns the directory."""
    from ..infer.pipeline import FastPitch2Wave

    dev = resolve_device(device)
    pipe = FastPitch2Wave(checkpoint, seed=seed, arabic_in=False,
                          compute_dtype=torch.bfloat16, device=dev)
    m = pipe.model
    _bake(pipe.vocoder, pipe.compute_dtype)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    f32, i64 = torch.float32, torch.long

    def encode(tokens, pitch_mul, pitch_add, speaker, pace):
        enc = m._encode_fn(tokens, pitch_mul, pitch_add, speaker, pace)
        return enc["enc_out"], enc["dur_pred"], enc["dec_len_max"]

    # the text axis of enc_out is the LARGEST text bucket: a smaller
    # bucket's encode is padded up to it before the wave call (the
    # regulator copies nothing from zero-duration pad tokens)
    tbx = max(text_buckets)
    for bs in batch_sizes:
        for tb in text_buckets:
            _export(encode, (torch.ones((bs, tb), dtype=i64, device=dev),
                             _scalar(1.0, f32, dev), _scalar(0.0, f32, dev),
                             _scalar(0, i64, dev), _scalar(1.0, f32, dev)),
                    out / _enc_name(bs, tb))
        for mb in mel_buckets:
            def wave(enc_out, durations, denoise, pace, _mb=mb):
                w, _, mel_lens = pipe._wave_fn(
                    enc_out, durations, denoise, pace, max_frames=_mb,
                    use_denoiser=True, out_int16=True)
                return w, mel_lens
            _export(wave, (torch.zeros((bs, tbx, m.config.d_model),
                                       device=dev),
                           torch.full((bs, tbx), 2.0, device=dev),
                           _scalar(0.005, f32, dev), _scalar(1.0, f32, dev)),
                    out / _wave_name(bs, mb))
    _write_manifest(out, model="fastpitch2wave",
                    sample_rate=pipe.sample_rate, hop_length=pipe.hop_length,
                    batch_sizes=list(batch_sizes),
                    text_buckets=list(text_buckets),
                    mel_buckets=list(mel_buckets), device=dev.type)
    return out


def _bucket(n: int, ladder) -> int:
    for b in sorted(ladder):
        if n <= b:
            return b
    return max(ladder)


class _Bundle:
    """A bundle's manifest and its programs, each loaded at first use
    (after `tts_arabic_torch.ops` has registered the ResBlock op)."""

    model = None

    def __init__(self, bundle_dir):
        from .. import ops  # noqa: F401  (registers tts_arabic::resblock1)
        self.dir = pathlib.Path(bundle_dir)
        self.manifest = json.loads((self.dir / "manifest.json").read_text())
        if self.manifest["model"] != self.model:
            raise ValueError(f"{self.dir} holds a {self.manifest['model']} "
                             f"bundle, not {self.model}")
        self.device = resolve_device(self.manifest["device"])
        self._progs = {}

    def _load(self, name):
        if name not in self._progs:
            self._progs[name] = torch.export.load(self.dir / name).module()
        return self._progs[name]

    def _batch(self, n: int, longest: int) -> tuple:
        """(batch size, text bucket) of n texts, the longest `longest`
        tokens; raises when no exported program holds them."""
        man = self.manifest
        if n > max(man["batch_sizes"]):
            raise ValueError(
                f"{n} texts > largest exported batch "
                f"{max(man['batch_sizes'])}; split the list or re-export "
                "with larger --batch-sizes")
        if longest > max(man["text_buckets"]):
            raise ValueError(
                "input longer than the largest exported text bucket "
                f"({max(man['text_buckets'])} tokens); re-export with "
                "larger --text-buckets")
        return (_bucket(n, man["batch_sizes"]),
                _bucket(longest, man["text_buckets"]))

    def _mel_bucket(self, frames: int) -> int:
        man = self.manifest
        if frames > max(man["mel_buckets"]):
            raise ValueError(
                f"mel length {frames} > largest exported mel bucket "
                f"{max(man['mel_buckets'])}; the output would be truncated "
                "- re-export with larger --mel-buckets")
        return _bucket(frames, man["mel_buckets"])

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)


class ServingBundle(_Bundle):
    """Serve FastPitch + HiFi-GAN `tts()` from an exported bundle: no
    weights file, no model code, no tracing."""

    model = "fastpitch2wave"

    def tts(self, texts: List[str], denoise: float = 0.005,
            speed: float = 1.0, speaker_id: int = 0,
            pitch_mul: float = 1.0, pitch_add: float = 0.0):
        """Buckwalter/phonetic inputs -> list of int16 waveforms."""
        from ..infer.pipeline import _exact_f32

        man = self.manifest
        ids = [np.asarray(text_frontend.tokens_to_ids(
            text_frontend.buckwalter_to_tokens(t, append_space=False)),
            np.int64) for t in texts]
        bs, tb = self._batch(len(ids), max(len(i) for i in ids))
        tbx = max(man["text_buckets"])
        tokens = np.zeros((bs, tb), np.int64)
        for r, i in enumerate(ids):
            tokens[r, : len(i)] = i
        f32 = torch.float32
        with _exact_f32():
            enc_out, durs, dec_len_max = self._load(_enc_name(bs, tb))(
                self._tensor(tokens, torch.long),
                self._tensor(pitch_mul, f32), self._tensor(pitch_add, f32),
                self._tensor(speaker_id, torch.long),
                self._tensor(speed, f32))
        mb = self._mel_bucket(int(dec_len_max))     # the one host sync
        pad = (0, tbx - tb)
        wave, mel_lens = self._load(_wave_name(bs, mb))(
            torch.nn.functional.pad(enc_out, (0, 0) + pad),
            torch.nn.functional.pad(durs, pad),
            self._tensor(denoise, f32), self._tensor(speed, f32))
        wave = wave.cpu().numpy()
        lens = mel_lens.cpu().numpy()
        hop = man["hop_length"]
        return [wave[r, : int(lens[r]) * hop] for r in range(len(ids))]


# --- Tacotron2 bundles ------------------------------------------------------

_BUFS = ("mel", "gate", "align")
_ENC = ("memory", "processed_memory", "memory_mask")


def _t2_name(kind: str, bs: int, n: int) -> str:
    return f"t2_{kind}_b{bs}_{'m' if kind == 'wave' else 't'}{n}.pt2"


def export_bundle_tacotron(out_dir, checkpoint: Optional[str] = None, *,
                           batch_sizes: Sequence[int] = (1,),
                           text_buckets: Sequence[int] = (32, 64),
                           mel_buckets: Sequence[int] = (256, 512),
                           max_steps: int = 768, device=None,
                           seed: int = 0) -> pathlib.Path:
    """Tacotron2 + HiFi-GAN bundle of the fused device path, in bf16:
    per (batch, text bucket) the encode (with the decode's first carry and
    zeroed buffers), one decode block and the finish (postnet, EOS
    truncation); per (batch, mel bucket) assemble + vocode + int16. The
    prenet's dropout masks are the live pipeline's default ones (a
    generator seeded 0), drawn here and baked in, so bundles are
    deterministic."""
    from ..infer.tacotron_pipeline import Tacotron2Wave

    dev = resolve_device(device)
    pipe = Tacotron2Wave(checkpoint, seed=seed, arabic_in=False,
                         compute_dtype=torch.bfloat16, device=dev)
    tts = pipe.model
    m, dt = tts.model, tts.dtype
    _bake(pipe.vocoder, dt)
    carry_keys = tuple(m.init_decode_carry(torch.zeros(1, 1, 1)))
    limit = torch.full((1,), max_steps, dtype=torch.long, device=dev)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n_c = len(carry_keys)

    def encode(tokens, lens, speakers):
        enc = m.encode_infer(tokens, lens, speakers, dtype=dt)
        carry = m.init_decode_carry(enc["memory"])
        m.start_segment(carry, limit)
        bufs = m.decode_buffers(enc["memory"], max_steps)
        return (*(enc[k] for k in _ENC), *(carry[k] for k in carry_keys),
                *(bufs[k] for k in _BUFS))

    def finish(mel, gate, align, lengths, trunc, post):
        o = m.finish_infer(dict(zip(_BUFS, (mel, gate, align))), lengths,
                           max_steps)
        n_end, new_len = pipe._newlen_fn(o["alignments"].float(),
                                         o["mel_lens"], trunc, post)
        return o["mel_postnet"].float(), n_end, new_len

    i64 = torch.long
    for bs in batch_sizes:
        masks = m.prenet_masks(max_steps, bs, dev)

        def block(*flat, _masks=masks):
            carry = dict(zip(carry_keys, flat[:n_c]))
            enc = dict(zip(_ENC, flat[n_c: n_c + 3]))
            bufs = dict(zip(_BUFS, flat[n_c + 3:]))
            m.decode_block(carry, enc, bufs, _masks, limit)
            return (*(carry[k] for k in carry_keys),
                    *(bufs[k] for k in _BUFS))

        for tb in text_buckets:
            args = (torch.ones((bs, tb), dtype=i64, device=dev),
                    torch.full((bs,), tb, dtype=i64, device=dev),
                    torch.zeros((bs,), dtype=i64, device=dev))
            _export(encode, args, out / _t2_name("encode", bs, tb))
            with torch.no_grad():
                state = encode(*args)
            enc_t, carry_t, bufs_t = (state[:3], state[3: 3 + n_c],
                                      state[3 + n_c:])
            _export(block, (*carry_t, *enc_t, *bufs_t),
                    out / _t2_name("decode", bs, tb))
            _export(finish, (*bufs_t, carry_t[carry_keys.index("lengths")],
                             torch.zeros((bs,), dtype=i64, device=dev),
                             torch.ones((bs,), dtype=torch.bool, device=dev)),
                    out / _t2_name("finish", bs, tb))
        for mb in mel_buckets:
            def wave(mel_post, n_end, new_len, post, denoise, _mb=mb):
                mel = pipe._assemble_fn(mel_post, n_end, new_len, post,
                                        bucket=_mb)
                return pipe._vocode_fn(mel, denoise, use_denoiser=True,
                                       out_int16=True)
            n = torch.full((bs,), 8, dtype=torch.int32, device=dev)
            _export(wave, (torch.zeros((bs, max_steps, m.config.n_mels),
                                       device=dev), n, n + 3,
                           torch.ones((bs,), dtype=torch.bool, device=dev),
                           _scalar(0.005, torch.float32, dev)),
                    out / _t2_name("wave", bs, mb))
    _write_manifest(out, model="tacotron2wave",
                    sample_rate=pipe.sample_rate, hop_length=pipe.hop_length,
                    max_steps=max_steps, carry=list(carry_keys),
                    batch_sizes=list(batch_sizes),
                    text_buckets=list(text_buckets),
                    mel_buckets=list(mel_buckets), device=dev.type)
    return out


class Tacotron2ServingBundle(_Bundle):
    """Serve Tacotron2 + HiFi-GAN from an exported bundle: encode, decode
    blocks until the run flag drops (one host read a block), EOS
    truncation, vocode; int16 output; the live pipeline's EOS
    postprocessing."""

    model = "tacotron2wave"

    def tts(self, texts: List[str], denoise: float = 0.005,
            speaker_id: int = 0, postprocess_mel: bool = True):
        from ..infer.pipeline import _exact_f32
        from ..infer.tacotron_pipeline import N_EOS, needs_postprocessing

        man = self.manifest
        toks_list, post = [], []
        for t in texts:
            toks = text_frontend.sanitize_tokens(
                text_frontend.buckwalter_to_tokens(t), None)
            p = postprocess_mel and needs_postprocessing(toks[-N_EOS - 1])
            if p:
                toks.insert(-N_EOS, text_frontend.SEPARATOR)
            toks_list.append(toks)
            post.append(p)
        ids = [np.asarray(text_frontend.tokens_to_ids(t), np.int64)
               for t in toks_list]
        bs, tb = self._batch(len(ids), max(len(i) for i in ids))
        tokens = np.zeros((bs, tb), np.int64)
        lens = np.ones((bs,), np.int64)
        trunc = np.zeros((bs,), np.int64)
        postv = np.zeros((bs,), bool)
        for r, (i, p) in enumerate(zip(ids, post)):
            tokens[r, : len(i)] = i
            lens[r] = len(i)
            trunc[r] = max(len(i) - N_EOS - 1, 0)
            postv[r] = p
        n_c = len(man["carry"])
        go = man["carry"].index("go")
        with _exact_f32():
            state = list(self._load(_t2_name("encode", bs, tb))(
                self._tensor(tokens, torch.long),
                self._tensor(lens, torch.long),
                self._tensor(np.full((bs,), speaker_id), torch.long)))
            enc, state = state[:3], state[3:]
            block = self._load(_t2_name("decode", bs, tb))
            while True:
                state = list(block(*state[:n_c], *enc, *state[n_c:]))
                if not bool(state[go]):     # one host read a block
                    break
            post_t = self._tensor(postv, torch.bool)
            mel_post, n_end, new_len = self._load(
                _t2_name("finish", bs, tb))(
                *state[n_c:], state[man["carry"].index("lengths")],
                self._tensor(trunc, torch.long), post_t)
        new_lens = new_len.cpu().numpy()
        mb = self._mel_bucket(max(int(new_lens[: len(ids)].max()), 1))
        wave = self._load(_t2_name("wave", bs, mb))(
            mel_post, n_end, new_len, post_t,
            self._tensor(denoise, torch.float32)).cpu().numpy()
        hop = man["hop_length"]
        return [wave[r, : int(new_lens[r]) * hop] for r in range(len(ids))]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="fastpitch",
                   choices=["fastpitch", "tacotron2"])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default=None,
                   help="where the bundle runs: cuda (default) or cpu")
    p.add_argument("--batch-sizes", default="1")
    p.add_argument("--text-buckets", default=None,
                   help="default 16,32,64 (fastpitch), 32,64 (tacotron2)")
    p.add_argument("--mel-buckets", default=None,
                   help="default 256,512,1024 (fastpitch), 256,512 "
                        "(tacotron2)")
    p.add_argument("--max-steps", type=int, default=768,
                   help="tacotron2 decode bound (frames)")
    a = p.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(","))  # noqa: E731
    kw = dict(batch_sizes=ints(a.batch_sizes), device=a.device)
    if a.text_buckets:
        kw["text_buckets"] = ints(a.text_buckets)
    if a.mel_buckets:
        kw["mel_buckets"] = ints(a.mel_buckets)
    if a.model == "tacotron2":
        out = export_bundle_tacotron(a.out, a.checkpoint,
                                     max_steps=a.max_steps, **kw)
    else:
        out = export_bundle(a.out, a.checkpoint, **kw)
    n = len(list(out.glob("*.pt2")))
    print(f"exported {n} programs -> {out}")


if __name__ == "__main__":
    main()
