"""Export a training checkpoint of the port to a reference-format `.pth`
(the port's counterpart of the JAX package's `apps/export_torch.py`).

    python -m tts_arabic_torch.apps.export_torch --model fastpitch \\
        --checkpoint checkpoints/exp_fp_adv/states.ckpt --out fastpitch_ft.pth
    python -m tts_arabic_torch.apps.export_torch --model tacotron2 ...
    python -m tts_arabic_torch.apps.export_torch --model hifigan \\
        --checkpoint checkpoints/exp_hifigan_ft/states.ckpt --out hifigan.pth

The port's modules keep the reference's state-dict names, so the model's
tensors are written as they are: FastPitch and Tacotron2 with the
`config` and `symbols` the reference wrappers build their models from
(`models/fastpitch/networks.py:52-60`, `models/tacotron2/networks.py:
96-98`), HiFi-GAN under `generator` with every conv split back into the
weight-norm pair that `load_hifigan` removes (`vocoder/__init__.py:3-20`):
`weight_g`/`weight_v` (the published artifact's layout) or
`parametrizations.weight.original0/1`. Host work only.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..runtime.checkpoint import load_states

# the port's Tacotron2Config field -> reference Tacotron2MS kwarg
# (tacotron2_ms.py:152-180; names differ only in pluralization)
_T2_REF_KEYS = {
    "n_symbols": "n_symbol",
    "encoder_n_convolutions": "encoder_n_convolution",
    "attention_location_n_filters": "attention_location_n_filter",
    "postnet_n_convolutions": "postnet_n_convolution",
}
_T2_SKIP = {"prenet_dropout"}  # the port's parity-test knob, not the ref's


def weight_norm_split(sd: dict, layout: str = "legacy") -> dict:
    """Every `<conv>.weight` of a HiFi-GAN state dict -> the weight-norm
    pair v = w, g = ||w|| over all but dim 0, which folds back to w
    exactly (`models.convert.fold_weight_norm`): `weight_g`/`weight_v`
    ("legacy") or `parametrizations.weight.original0/1`. Other keys pass
    through."""
    if layout not in ("legacy", "parametrizations"):
        raise ValueError(f"unknown weight-norm layout {layout!r}")
    g_key, v_key = (("weight_g", "weight_v") if layout == "legacy" else
                    ("parametrizations.weight.original0",
                     "parametrizations.weight.original1"))
    out = {}
    for key, val in sd.items():
        if not key.endswith(".weight"):
            out[key] = val
            continue
        base = key[: -len("weight")]
        w = np.ascontiguousarray(val.detach().cpu().numpy())
        g = np.sqrt((w.reshape(w.shape[0], -1) ** 2).sum(1))
        out[base + g_key] = torch.from_numpy(
            g.reshape(-1, *[1] * (w.ndim - 1)))
        out[base + v_key] = torch.from_numpy(w)
    return out


def save_reference_checkpoint(path, sd: dict, *, key: str = "model",
                              config: dict | None = None, symbols=None):
    """torch.save a reference-layout `.pth`: {key: tensors(, config,
    symbols)}."""
    payload = {key: {k: v.detach().cpu().contiguous() for k, v in sd.items()}}
    if config is not None:
        payload["config"] = dict(config)
    if symbols is not None:
        payload["symbols"] = list(symbols)
    torch.save(payload, path)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True,
                   choices=["fastpitch", "tacotron2", "hifigan"])
    p.add_argument("--checkpoint", required=True,
                   help="the port's states.ckpt (training) checkpoint")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--weight-norm-layout", default="legacy",
                   choices=["legacy", "parametrizations"],
                   help="hifigan only: weight_g/weight_v (published "
                        "artifact) or modern parametrizations keys")
    a = p.parse_args(argv)

    from ..text import symbols

    st = load_states(a.checkpoint)
    net_config = (st.get("config") or {}).get("net_config") or {}
    sd = st["model"]
    if a.model == "fastpitch":
        from ..models.fastpitch import FastPitchConfig
        config = FastPitchConfig.from_reference_net_config(net_config)
        save_reference_checkpoint(
            a.out, sd, config=config.to_reference_net_config(),
            symbols=symbols)
    elif a.model == "tacotron2":
        from ..models.tacotron2 import Tacotron2Config
        config = Tacotron2Config(**{
            k: v for k, v in net_config.items()
            if k in Tacotron2Config.__dataclass_fields__})
        ref_cfg = {_T2_REF_KEYS.get(k, k): v
                   for k, v in dataclasses.asdict(config).items()
                   if k not in _T2_SKIP}
        save_reference_checkpoint(a.out, sd, config=ref_cfg,
                                  symbols=symbols)
    else:
        sd = weight_norm_split(sd, a.weight_norm_layout)
        save_reference_checkpoint(a.out, sd, key="generator")
    print(f"exported {a.model} -> {a.out} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
