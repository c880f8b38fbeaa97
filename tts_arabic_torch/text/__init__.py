"""Text frontend: Buckwalter transliteration, MSA G2P, tokenization.

The port's own copy of the JAX package's pure-Python `text/` (the port
imports nothing of that package).
"""
from .buckwalter import arabic_to_buckwalter, buckwalter_to_arabic
from .phonetizer import process_utterance, process_word, normalize_utterance
from .symbols import (
    DOUBLING, DOUBLING_TOKEN, EOS, EOS_TOKEN, EOS_TOKENS, NUM_SYMBOLS, PAD,
    PADDING_TOKEN, SEPARATOR, SEPARATOR_TOKEN, SIL, SYMBOL_TO_ID, symbols,
)
from .tokenizer import (
    VOWEL_MAP, arabic_to_phonemes, arabic_to_tokens, buckwalter_to_phonemes,
    buckwalter_to_tokens, ids_to_tokens, phonemes_to_tokens,
    sanitize_tokens, simplify_phonemes, tokens_to_ids,
)

__all__ = [
    "arabic_to_buckwalter", "buckwalter_to_arabic", "process_utterance",
    "process_word", "normalize_utterance", "symbols", "NUM_SYMBOLS",
    "SYMBOL_TO_ID", "PAD", "EOS", "SIL", "DOUBLING", "SEPARATOR",
    "PADDING_TOKEN", "EOS_TOKEN", "DOUBLING_TOKEN", "SEPARATOR_TOKEN",
    "EOS_TOKENS", "VOWEL_MAP", "arabic_to_phonemes", "arabic_to_tokens",
    "buckwalter_to_phonemes", "buckwalter_to_tokens", "ids_to_tokens",
    "phonemes_to_tokens", "sanitize_tokens", "simplify_phonemes",
    "tokens_to_ids",
]
