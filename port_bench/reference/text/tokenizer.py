"""Phoneme-string -> model-token pipeline.

Capability parity with reference `text/__init__.py:24-78`: strips silence
marks, rewrites geminates as `C _dbl_`, collapses the 20 context-variant
vowels of the phonetizer down to the 6 model vowels, and appends the
separator/EOS specials.
"""
from __future__ import annotations

from .buckwalter import arabic_to_buckwalter
from .phonetizer import process_utterance
from .symbols import (DOUBLING, EOS, SEPARATOR, SYMBOL_TO_ID, symbols)

# Context-variant vowel -> model vowel (emphatic/milden variants collapse).
VOWEL_MAP = {
    v: base
    for base, variants in {
        "aa": ["aa", "AA"],
        "uu": ["uu0", "uu1", "UU0", "UU1"],
        "ii": ["ii0", "ii1", "II0", "II1"],
        "a": ["a", "A"],
        "u": ["u0", "u1", "U0", "U1"],
        "i": ["i0", "i1", "I0", "I1"],
    }.items()
    for v in variants
}

VARIANT_VOWELS = frozenset(VOWEL_MAP)


def phonemes_to_tokens(phonemes: str, append_space: bool = True) -> list[str]:
    """Convert a phonetizer output string into model tokens."""
    toks = phonemes.replace("sil", "").replace("+", SEPARATOR).split()
    out: list[str] = []
    for tok in toks:
        if len(tok) == 2 and tok not in VARIANT_VOWELS and tok[0] == tok[1]:
            # geminate consonant: emit base consonant + doubling token
            out.append(tok[0])
            out.append(DOUBLING)
            continue
        out.append(VOWEL_MAP.get(tok, tok))
    if append_space:
        out.append(SEPARATOR)
    out.append(EOS)
    return out


def tokens_to_ids(tokens: list[str], phon_to_id: dict | None = None,
                  strict: bool = True) -> list[int]:
    """Token strings -> model ids.

    `strict=True` reproduces the reference behavior exactly — a token
    outside the symbol table raises KeyError (reference
    `text/__init__.py:24-27` crashes on trailing punctuation like
    `"..."` this way). `strict=False` degrades gracefully: unknown
    tokens are dropped and the separator runs that punctuation
    stripping leaves behind are collapsed (a leading separator is
    dropped too), so any real-world sentence tokenizes.
    """
    table = SYMBOL_TO_ID if phon_to_id is None else phon_to_id
    if strict:
        return [table[t] for t in tokens]
    return [table[t] for t in sanitize_tokens(tokens, phon_to_id)]


def sanitize_tokens(tokens: list[str],
                    phon_to_id: dict | None = None) -> list[str]:
    """Graceful-degradation filter for real-world text: drop tokens the
    symbol table doesn't know (punctuation the G2P passes through),
    collapse the separator runs that leaves behind, and drop a leading
    separator. Identity on any token list that already maps cleanly."""
    table = SYMBOL_TO_ID if phon_to_id is None else phon_to_id
    out: list[str] = []
    prev_sep = True  # drop a leading separator
    for t in tokens:
        if t not in table:
            continue
        if t == SEPARATOR:
            if prev_sep:
                continue
            prev_sep = True
        else:
            prev_sep = False
        out.append(t)
    return out


def ids_to_tokens(ids) -> list[str]:
    return [symbols[i] for i in ids]


def arabic_to_phonemes(arabic: str) -> str:
    return process_utterance(arabic_to_buckwalter(arabic))


def buckwalter_to_phonemes(buckw: str) -> str:
    return process_utterance(buckw)


def buckwalter_to_tokens(buckw: str, append_space: bool = True) -> list[str]:
    return phonemes_to_tokens(process_utterance(buckw), append_space)


def arabic_to_tokens(arabic: str, append_space: bool = True) -> list[str]:
    return buckwalter_to_tokens(arabic_to_buckwalter(arabic), append_space)


def simplify_phonemes(phonemes: str) -> str:
    """Collapse context-variant vowels inside a phoneme string."""
    for variant, base in VOWEL_MAP.items():
        phonemes = phonemes.replace(variant, base)
    return phonemes
