"""The port's copy of the text frontend equals the JAX package's, exactly,
on every line of the corpus test files."""
import pathlib
import re

import pytest

from tts_arabic_torch import text as port_text
from tts_arabic_tpu import text as jax_text

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
_LINE = re.compile(r'"[^"]+"\s+"(?P<text>[^"]+)"')


def _lines(name):
    out = []
    for line in (DATA / name).read_text(encoding="utf-8").splitlines():
        m = _LINE.match(line)
        if m:
            out.append(m.group("text"))
    return out


def _ids(mod, tokens, strict):
    try:
        return mod.tokens_to_ids(tokens, strict=strict)
    except KeyError as e:
        return ("KeyError", e.args)


@pytest.mark.parametrize("name,fn", [
    ("test_buckw.txt", "buckwalter_to_tokens"),
    ("test_arab.txt", "arabic_to_tokens"),
])
def test_tokens_and_ids_equal_jax_package(name, fn):
    lines = _lines(name)
    assert len(lines) == 100
    for line in lines:
        for append_space in (False, True):
            ref = getattr(jax_text, fn)(line, append_space=append_space)
            got = getattr(port_text, fn)(line, append_space=append_space)
            assert got == ref, line
        for strict in (False, True):
            assert _ids(port_text, got, strict) == _ids(jax_text, ref,
                                                         strict), line


def test_buckwalter_roundtrip_equal_jax_package():
    for line in _lines("test_arab.txt"):
        bw = port_text.arabic_to_buckwalter(line)
        assert bw == jax_text.arabic_to_buckwalter(line)
        assert port_text.buckwalter_to_arabic(bw) == \
            jax_text.buckwalter_to_arabic(bw)
