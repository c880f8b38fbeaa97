"""Diacritizer networks and their host-side encode/decode (torch
counterpart of the JAX package's `diacritizers/models.py`).

Shakkala (reference `models/diacritizers/shakkala/network.py:8-77`):
  Embedding(149->288) -> BiLSTM-hardsigmoid(288) -> BatchNorm (eps 1e-3)
  -> BiLSTM-hs(144) -> BiLSTM-hs(96) -> Linear(192->28) -> softmax; the
  hard-sigmoid gates are Keras semantics (`lstm_hsm.py:352-379`).

Shakkelha (reference `models/diacritizers/shakkelha/network.py:9-80`):
  Embedding(91->25) -> BiLSTM(256) x2 -> Dense(512) x2 ReLU -> Dense(19)
  softmax; decode skips non-Arabic characters and '<'-prefixed classes.

`nn.LSTM` has no hard-sigmoid gate, so one plain recurrence serves both
models: the input projection of every step is one matmul, then a per-step
loop runs both directions together. Parameters keep the reference's state
dict layout (`nn.LSTM`'s `weight_ih_l0{,_reverse}` keys and so on), so the
published `.pth` files load as they are.

`predict(list)` runs one padded batch (rows padded to a 32-character
bucket) whose recurrence holds its carry at padded steps, so every row
equals that sentence run alone.
"""
from __future__ import annotations

import json
import pathlib
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..models.convert import (diacritizer_params_to_torch,
                              load_reference_pth, to_tensors)
from ..runtime.device import resolve_device

_HERE = pathlib.Path(__file__).parent
_LEN_BUCKET = 32  # padded batches round their length up to this


def _load_vocab(name):
    with open(_HERE / name, encoding="utf-8") as f:
        return json.load(f)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Keras hard sigmoid: clip(0.2x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class BiLSTM(nn.Module):
    """One bidirectional LSTM layer, gate order [i, f, g, o], with any gate
    activation, in `nn.LSTM`'s parameter layout."""

    def __init__(self, c_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for suffix in ("", "_reverse"):
            for name, shape in (("weight_ih", (4 * hidden, c_in)),
                                ("weight_hh", (4 * hidden, hidden)),
                                ("bias_ih", (4 * hidden,)),
                                ("bias_hh", (4 * hidden,))):
                self.register_parameter(f"{name}_l0{suffix}", nn.Parameter(
                    torch.zeros(shape), requires_grad=False))

    def _stacked(self, name):
        return torch.stack([getattr(self, f"{name}_l0"),
                            getattr(self, f"{name}_l0_reverse")])

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                gate=torch.sigmoid) -> torch.Tensor:
        """x [B, T, C], mask [B, T] (True on valid steps, right padding)
        -> [B, T, 2H]. The carry holds at masked steps, so the forward pass
        and the backward pass over the reversed rows give each row's
        unpadded result at its valid steps."""
        B, T, _ = x.shape
        xs = torch.stack([x, x.flip(1)])                  # [2, B, T, C]
        ms = torch.stack([mask, mask.flip(1)])[..., None]  # [2, B, T, 1]
        w_ih = self._stacked("weight_ih").transpose(1, 2)  # [2, C, 4H]
        w_hh = self._stacked("weight_hh").transpose(1, 2)  # [2, H, 4H]
        bias = self._stacked("bias_ih") + self._stacked("bias_hh")
        proj = torch.matmul(xs, w_ih[:, None]) + bias[:, None, None]
        h = x.new_zeros((2, B, self.hidden))
        c = torch.zeros_like(h)
        ys = []
        for t in range(T):
            z = proj[:, :, t] + torch.bmm(h, w_hh)         # [2, B, 4H]
            i, f, _, o = gate(z).chunk(4, dim=-1)
            g = torch.tanh(z[..., 2 * self.hidden: 3 * self.hidden])
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            m = ms[:, :, t]
            h = torch.where(m, h_new, h)
            c = torch.where(m, c_new, c)
            ys.append(h_new)
        y = (torch.stack(ys, dim=2) if ys
             else x.new_zeros((2, B, 0, self.hidden)))
        return torch.cat([y[0], y[1].flip(1)], dim=-1)


class _BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis, Keras' eps 1e-3, in
    `nn.BatchNorm1d`'s parameter names."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return ((x - self.running_mean)
                / torch.sqrt(self.running_var + self.eps) * self.weight
                + self.bias)


def _random_lstm(mk, c_in, hidden):
    one = lambda: {"wi": mk(c_in, 4 * hidden),  # noqa: E731
                   "wh": mk(hidden, 4 * hidden),
                   "bi": mk(4 * hidden), "bh": mk(4 * hidden)}
    return {"fwd": one(), "bwd": one()}


class _Diacritizer(nn.Module):
    """Weights from a reference `.pth`, a JAX-layout parameter dict, or
    seeded random values; `predict` on top of `forward(ids, mask)`."""

    def _setup(self, sd_path, params, seed, device):
        if sd_path is not None:
            sd, _ = load_reference_pth(sd_path)
            sd.pop("bn0.num_batches_tracked", None)
        else:
            if params is None:
                params = self._random_params(seed)
            sd = to_tensors(diacritizer_params_to_torch(params))
        self.load_state_dict({k: v.float() for k, v in sd.items()},
                             strict=True)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    def _encode(self, text) -> np.ndarray:
        raise NotImplementedError

    def _probs(self, ids_list, bucket: bool) -> list:
        """One forward over the id rows, right-padded to the longest (and
        up to a multiple of _LEN_BUCKET with `bucket`); per-row
        probabilities [len, n_classes] as numpy."""
        L = max(len(r) for r in ids_list)
        if bucket:
            L = -(-L // _LEN_BUCKET) * _LEN_BUCKET
        ids = np.zeros((len(ids_list), L), np.int64)
        mask = np.zeros((len(ids_list), L), bool)
        for b, row in enumerate(ids_list):
            ids[b, : len(row)] = row
            mask[b, : len(row)] = True
        with torch.no_grad():
            probs = self(torch.from_numpy(ids).to(self.device),
                         torch.from_numpy(mask).to(self.device))
        probs = probs.float().cpu().numpy()
        return [probs[b, : len(r)] for b, r in enumerate(ids_list)]

    def _prepare(self, text: str) -> str:
        return text

    def predict(self, text: Union[str, List[str]], return_probs=False):
        """Vowelize one sentence or a list (one batched forward); with
        `return_probs` also each sentence's class probabilities."""
        single = isinstance(text, str)
        texts = [self._prepare(t) for t in ([text] if single else text)]
        if not texts:
            return ([], []) if return_probs else []
        probs = self._probs([self._encode(t) for t in texts],
                            bucket=not single)
        outs = [self._decode(t, p) for t, p in zip(texts, probs)]
        if single:
            return (outs[0], probs[0]) if return_probs else outs[0]
        return (outs, probs) if return_probs else outs


class Shakkala(_Diacritizer):
    """Hard-sigmoid BiLSTM diacritizer."""

    def __init__(self, sd_path: Optional[str] = None, params=None,
                 seed: int = 0, device=None, dim_in: int = 149,
                 dim_out: int = 28):
        super().__init__()
        vocab = _load_vocab("vocab_shakkala.json")
        self.char_to_id = vocab["input_vocab_to_int"]
        self.id_to_class = {int(k): v for k, v in
                            vocab["output_int_to_vocab"].items()}
        self.emb_input = nn.Embedding(dim_in, 288)
        self.lstm0 = BiLSTM(288, 288)
        self.bn0 = _BatchNorm(576)
        self.lstm1 = BiLSTM(576, 144)
        self.lstm2 = BiLSTM(288, 96)
        self.dense0 = nn.Linear(192, dim_out)
        self._setup(sd_path, params, seed, device)

    @staticmethod
    def _random_params(seed, dim_in=149, dim_out=28):
        """The JAX package's seeded weights, drawn in the same order."""
        rng = np.random.default_rng(seed)
        mk = lambda *s: (rng.standard_normal(s).astype(np.float32)  # noqa
                         * 0.05)
        lstm = lambda i, h: _random_lstm(mk, i, h)  # noqa: E731
        return {
            "emb": mk(dim_in, 288),
            "lstm0": lstm(288, 288),
            "bn0": {"scale": np.ones(576, np.float32),
                    "bias": np.zeros(576, np.float32),
                    "mean": np.zeros(576, np.float32),
                    "var": np.ones(576, np.float32)},
            "lstm1": lstm(576, 144),
            "lstm2": lstm(288, 96),
            "dense0": {"w": mk(192, dim_out), "b": mk(dim_out)},
        }

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids, mask [B, T] -> class probabilities [B, T, 28]."""
        x = self.emb_input(ids)
        x = self.lstm0(x, mask, hard_sigmoid)
        # BN shifts the pad rows; zero them again for lstm1's input
        x = self.bn0(x) * mask[..., None].to(x.dtype)
        x = self.lstm1(x, mask, hard_sigmoid)
        x = self.lstm2(x, mask, hard_sigmoid)
        return torch.softmax(self.dense0(x), dim=-1)

    def _encode(self, text):
        unk = self.char_to_id["<UNK>"]
        return np.asarray([self.char_to_id.get(ch, unk) for ch in text],
                          np.int64)

    def _decode(self, text, probs):
        out = []
        for ch, cls in zip(text, probs.argmax(-1)):
            haraka = self.id_to_class[int(cls)]
            if haraka in ("<UNK>", "ـ"):
                haraka = ""
            out.append(ch + haraka)
        return "".join(out)


class Shakkelha(_Diacritizer):
    """Standard (sigmoid-gate) BiLSTM diacritizer."""

    def __init__(self, sd_path: Optional[str] = None, params=None,
                 seed: int = 0, device=None, dim_in: int = 91,
                 dim_out: int = 19):
        super().__init__()
        vocab = _load_vocab("vocab_shakkelha.json")
        self.char_to_id = vocab["big_characters_mapping"]
        self.rev_classes = {int(k): v for k, v in
                            vocab["rev_classes_mapping"].items()}
        self.arabic_letters = set(vocab["arabic_letters"])
        self.diacritics = set(vocab["diacritics"])
        self.emb0 = nn.Embedding(dim_in, 25)
        self.lstm0 = BiLSTM(25, 256)
        self.lstm1 = BiLSTM(512, 256)
        self.dense0 = nn.Linear(512, 512)
        self.dense1 = nn.Linear(512, 512)
        self.dense2 = nn.Linear(512, dim_out)
        self._setup(sd_path, params, seed, device)

    @staticmethod
    def _random_params(seed, dim_in=91, dim_out=19):
        """The JAX package's seeded weights, drawn in the same order."""
        rng = np.random.default_rng(seed)
        mk = lambda *s: (rng.standard_normal(s).astype(np.float32)  # noqa
                         * 0.05)
        lstm = lambda i, h: _random_lstm(mk, i, h)  # noqa: E731
        return {
            "emb": mk(dim_in, 25),
            "lstm0": lstm(25, 256),
            "lstm1": lstm(512, 256),
            "dense0": {"w": mk(512, 512), "b": mk(512)},
            "dense1": {"w": mk(512, 512), "b": mk(512)},
            "dense2": {"w": mk(512, dim_out), "b": mk(dim_out)},
        }

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids, mask [B, T] -> class probabilities [B, T, 19]."""
        x = self.emb0(ids)
        x = self.lstm0(x, mask)
        x = self.lstm1(x, mask)
        x = torch.relu(self.dense0(x))
        x = torch.relu(self.dense1(x))
        return torch.softmax(self.dense2(x), dim=-1)

    def _prepare(self, text):
        """Strip the diacritics the input already has."""
        return "".join(ch for ch in text if ch not in self.diacritics)

    def _encode(self, stripped):
        unk = self.char_to_id["<UNK>"]
        ids = [self.char_to_id["<SOS>"]]
        ids += [self.char_to_id.get(ch, unk) for ch in stripped]
        ids.append(self.char_to_id["<EOS>"])
        return np.asarray(ids, np.int64)

    def _decode(self, stripped, probs):
        out = []
        for ch, pr in zip(stripped, probs[1:]):  # skip the <SOS> position
            out.append(ch)
            if ch not in self.arabic_letters:
                continue
            cls = self.rev_classes[int(pr.argmax())]
            if "<" in cls:
                continue
            out.append(cls)
        return "".join(out)


def load_vowelizer(name: str, config=None, device=None):
    """name -> a loaded diacritizer (reference
    `models/diacritizers/__init__.py:4-12`), its weights from the config's
    `shakkala_path` / `shakkelha_path` (configs/basic.yaml), or seeded
    random weights when that file is absent."""
    models = {"shakkala": Shakkala, "shakkelha": Shakkelha}
    if name not in models:
        raise ValueError(f"unknown vowelizer '{name}' "
                         "(options: shakkala, shakkelha)")
    if config is None:
        from ..runtime.config import get_basic_config
        config = get_basic_config()
    path = config.get_path(f"{name}_path")
    return models[name](sd_path=str(path) if path.exists() else None,
                        device=device)
