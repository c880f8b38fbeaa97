"""Layered YAML configuration (the port's copy of the JAX package's
`runtime/config.py`): a base config (`configs/basic.yaml`) updated by an
experiment config, exposed as an attribute-style dict.

The port reads YAML itself, since the card's installation has no PyYAML.
It reads the subset that `configs/*.yaml` use, one `key: value` per
line: plain scalars resolved as PyYAML's safe loader resolves them (YAML
1.1 ints, floats, booleans and nulls, else strings), single- and
double-quoted strings, inline lists of those, and `#` comments. A key
with no value followed by lines indented deeper opens a nested block
mapping of the same kind (the shape of a Vocos hparams file:
`backbone:` / `init_args:` / `dim: 512`). It also reads a top-level list
of such mappings (`- key: value` opening each item, its other keys
indented under the first), the shape of the server's model registry
`app_models.yaml`. Anything else (flow maps, block lists below the top,
anchors, tabs) raises ValueError.
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
_ITEM = re.compile(r"-(\s+)(\S.*)$")


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


def _lines(text: str) -> list:
    """(indent, line) of every line that is not blank or a comment."""
    out = []
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[indent] == "\t":
            raise ValueError(f"unsupported YAML indentation (tab): {line!r}")
        out.append((indent, line))
    return out


def _mapping(lines: list, i: int, indent: int):
    """The block mapping whose keys sit at column `indent`, from lines[i]
    on; returns (dict, index of the first line after it)."""
    out = {}
    while i < len(lines):
        col, line = lines[i]
        if col < indent:
            break
        m = _KEY.match(line, col) if col == indent else None
        if m is None:
            raise ValueError(f"unsupported YAML line (the port reads "
                             f"`key: value` lines and nested block "
                             f"mappings only): {line!r}")
        rest = m.group(2).strip()
        i += 1
        if (rest == "" or rest.startswith("#")) and i < len(lines) \
                and lines[i][0] > indent:
            out[m.group(1)], i = _mapping(lines, i, lines[i][0])
        else:
            out[m.group(1)] = _value(rest, line)
    return out, i


def parse_yaml(text: str):
    """The YAML subset above -> a dict, or a list of dicts."""
    lines = _lines(text)
    if not lines:
        return {}
    if _ITEM.match(lines[0][1]) is None:
        out, end = _mapping(lines, 0, 0)
        if end != len(lines):
            raise ValueError(f"unsupported YAML line: {lines[end][1]!r}")
        return out
    items, i = [], 0
    while i < len(lines):
        col, line = lines[i]
        item = _ITEM.match(line) if col == 0 else None
        if item is None:
            raise ValueError(f"unsupported YAML line in a list of "
                             f"mappings: {line!r}")
        indent = 1 + len(item.group(1))         # the item's first key
        lines[i] = (indent, " " * indent + item.group(2))
        mapping, i = _mapping(lines, i, indent)
        items.append(mapping)
    return items


def load_yaml(path) -> DictConfig:
    return DictConfig(parse_yaml(pathlib.Path(path).read_text()))


def get_basic_config(basic_path=None) -> DictConfig:
    """configs/basic.yaml (or the given file), as the JAX package's
    `get_basic_config` reads it."""
    return load_yaml(basic_path or DEFAULT_BASIC_CONFIG)


def get_config(experiment_path) -> DictConfig:
    """basic.yaml overlaid with an experiment YAML (flat update, as the
    reference `utils/__init__.py:35-40` does)."""
    cfg = get_basic_config()
    cfg.update(load_yaml(experiment_path))
    return cfg
