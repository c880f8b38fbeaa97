"""Token inventory for the Arabic TTS models.

Capability parity with reference `text/symbols.py:1-53` — the same 40-entry
vocabulary (5 specials, 29 consonants, 6 vowels) in the same order, since
checkpoint embeddings are indexed by this order.
"""

PAD = "_pad_"
EOS = "_eos_"
SIL = "_sil_"
DOUBLING = "_dbl_"
SEPARATOR = "_+_"

# Back-compat aliases matching the reference's public names
# (reference text/symbols.py:2-7).
PADDING_TOKEN = PAD
EOS_TOKEN = EOS
DOUBLING_TOKEN = DOUBLING
SEPARATOR_TOKEN = SEPARATOR
EOS_TOKENS = [SEPARATOR, EOS]

_SPECIALS = [PAD, EOS, SIL, DOUBLING, SEPARATOR]

# Buckwalter-style consonant phonemes, canonical model order.
_CONSONANTS = list("<") + [
    "b", "t", "^", "j", "H", "x", "d", "*", "r", "z", "s", "$",
    "S", "D", "T", "Z", "E", "g", "f", "q", "k", "l", "m", "n",
    "h", "w", "y", "v",
]

_VOWELS = ["a", "u", "i", "aa", "uu", "ii"]

symbols = _SPECIALS + _CONSONANTS + _VOWELS

NUM_SYMBOLS = len(symbols)  # 40

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = dict(enumerate(symbols))
