"""Token ids of an utterance, by the frozen copy of the frontend."""
from __future__ import annotations

from . import text


def ids(utterance: str) -> list[int]:
    """The model token ids of one Buckwalter utterance, tokens outside the
    symbol table dropped, no trailing separator: what the published
    FastPitch wrapper feeds its encoder."""
    return text.tokens_to_ids(
        text.buckwalter_to_tokens(utterance, append_space=False), None,
        strict=False)
