"""Layered YAML configuration (the port's copy of the JAX package's
`runtime/config.py`): a base config (`configs/basic.yaml`) updated by an
experiment config, exposed as an attribute-style dict.

The port reads YAML itself, since the card's installation has no PyYAML.
It reads the flat subset that `configs/*.yaml` use, one `key: value` per
line: plain scalars resolved as PyYAML's safe loader resolves them (YAML
1.1 ints, floats, booleans and nulls, else strings), single- and
double-quoted strings, inline lists of those, and `#` comments. Anything
else (indented blocks, nested maps, anchors) raises ValueError.
"""
from __future__ import annotations

import json
import pathlib
import re
from typing import Any

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_BASIC_CONFIG = _REPO_ROOT / "configs" / "basic.yaml"

# PyYAML's implicit resolvers (yaml/resolver.py), without the sexagesimal
# and underscore-free corner cases no config uses
_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_NULL = {"", "~", "null"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*:(?:\s+|$)(.*)$")


class DictConfig(dict):
    """dict with attribute access (`cfg.key` == `cfg['key']`)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, name: str) -> pathlib.Path:
        """Resolve a path-valued key relative to the repo root."""
        p = pathlib.Path(self[name])
        return p if p.is_absolute() else _REPO_ROOT / p


def _plain(tok: str):
    low = tok.lower()
    if low in _NULL:
        return None
    if low in _BOOL:
        return _BOOL[low]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    return tok


def _scalar(text: str, pos: int, stops: str):
    """Parse one scalar of `text` from `pos`; returns (value, next pos).
    A plain scalar ends at a character of `stops` or a ' #' comment."""
    if text.startswith("'", pos):
        end = pos + 1
        while True:
            end = text.find("'", end)
            if end < 0:
                raise ValueError(f"unterminated quote: {text!r}")
            if text.startswith("''", end):
                end += 2
                continue
            return text[pos + 1:end].replace("''", "'"), end + 1
    if text.startswith('"', pos):
        m = re.compile(r'"(?:[^"\\]|\\.)*"').match(text, pos)
        if m is None:
            raise ValueError(f"unterminated quote: {text!r}")
        return json.loads(m.group(0)), m.end()
    end = pos
    while end < len(text) and text[end] not in stops and not (
            text[end] == "#" and text[end - 1].isspace()):
        end += 1
    return _plain(text[pos:end].strip()), end


def _value(text: str, line: str):
    text = text.strip()
    if text[:1] in ("{", "&", "*", "!", "|", ">", "@", "`", "%"):
        raise ValueError(f"unsupported YAML value: {line!r}")
    if not text.startswith("["):
        value, end = _scalar(text, 0, "")
        rest = text[end:].strip()
    else:
        value, pos = [], 1
        while True:
            while pos < len(text) and text[pos].isspace():
                pos += 1
            if text.startswith("]", pos) and not value:
                pos += 1
                break
            item, pos = _scalar(text, pos, ",]")
            value.append(item)
            while pos < len(text) and text[pos].isspace():
                pos += 1
            if text.startswith(",", pos):
                pos += 1
            elif text.startswith("]", pos):
                pos += 1
                break
            else:
                raise ValueError(f"unsupported list: {line!r}")
        rest = text[pos:].strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"unsupported YAML line: {line!r}")
    return value


def parse_yaml(text: str) -> dict:
    """The flat YAML subset above -> dict."""
    out = {}
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"unsupported YAML line (the port reads flat "
                             f"`key: value` lines only): {line!r}")
        out[m.group(1)] = _value(m.group(2), line)
    return out


def load_yaml(path) -> DictConfig:
    return DictConfig(parse_yaml(pathlib.Path(path).read_text()))


def get_config(experiment_path) -> DictConfig:
    """basic.yaml overlaid with an experiment YAML (flat update, as the
    reference `utils/__init__.py:35-40` does)."""
    cfg = load_yaml(DEFAULT_BASIC_CONFIG)
    cfg.update(load_yaml(experiment_path))
    return cfg
