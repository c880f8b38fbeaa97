"""Rule-based Modern Standard Arabic grapheme-to-phoneme engine.

Re-implementation (behavior-parity, new structure) of the Nawar Halabi MSA
phonetisation rule set used by the reference (`text/phonetise_buckwalter.py:
164-400`): utterance normalization, a per-word left-to-right rule pass with
emphatic-context tracking, a fixed-word lexicon for irregular pronunciations,
multi-pronunciation expansion, and a duplicate-vowel cleanup pass.

The engine is verified golden against every line of the reference corpus
(`data/train_buckw.txt` -> `data/train_phon.txt`), so it reproduces the
reference's exact output — including two upstream quirks that the corpus was
generated with:

* The "non-emphatic consonants except lam/ra keep emphasis" rule has a string
  literal bug upstream (`phonetise_buckwalter.py:223`), with the effect that
  *every* non-emphatic consonant (including l/r) resets the emphatic flag.
* A shadda following a branch-point letter doubles the list of alternatives
  rather than geminating each one (`phonetise_buckwalter.py:245-246`).

Phones are Buckwalter-flavoured phoneme strings; a word expands to a list of
phones, each slot either a single phone or a list of alternatives ('' = omit).
"""
from __future__ import annotations

import functools
import re

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

# Consonant graphemes with a single fixed phone (all hamza forms merge to '<').
SIMPLE_CONSONANTS = {c: c for c in "b*tTmrZn^zEhjsgHqfxS$dDk"} | {
    ">": "<", "'": "<", "}": "<", "&": "<", "<": "<",
}

# Vowel table: grapheme -> (plain_variants, emphatic_variants).
# For A/Y/w/y/u/i each variant set is (default, alternate); for 'a' it is a
# bare string per emphatic state.
LONG_A = ("aa", "")
LONG_A_EMPH = ("AA", "")
VOWEL_TABLE = {
    "A": (LONG_A, LONG_A_EMPH),
    "Y": (LONG_A, LONG_A_EMPH),
    "w": (("uu0", "uu1"), ("UU0", "UU1")),
    "y": (("ii0", "ii1"), ("II0", "II1")),
    "a": ("a", "A"),
    "u": (("u0", "u1"), ("U0", "U1")),
    "i": (("i0", "i1"), ("I0", "I1")),
}

MADDA_PLAIN = ["<", "aa"]
MADDA_EMPHATIC = ["<", "AA"]

DIACRITICS = set("oauiFNK~")
SHORT_DIACRITICS = set("oauiFNK")  # diacritics minus shadda
EMPHATICS = set("DSTZgxq")
FORWARD_EMPHATICS = set("gx")
CONSONANT_LETTERS = set(">'<}&bt^jHxd*rzs$SDTZEgfqklmnh|")
PUNCTUATION = {".", ",", "?", "!"}

# Irregular words, keyed by consonant skeleton; values are candidate
# pronunciations (most-specific contexts first).
FIXED_WORDS: dict[str, list[str] | str] = {
    "h*A": ["h aa * aa", "h aa * a"],
    "h*h": ["h aa * i0 h i0", "h aa * i1 h"],
    "h*An": ["h aa * aa n i0", "h aa * aa n"],
    "h&lA'": ["h aa < u0 l aa < i0", "h aa < u0 l aa <"],
    "*lk": ["* aa l i0 k a", "* aa l i0 k"],
    "k*lk": ["k a * aa l i0 k a", "k a * aa l i1 k"],
    "*lkm": "* aa l i0 k u1 m",
    ">wl}k": ["< u0 l aa < i0 k a", "< u0 l aa < i1 k"],
    "Th": "T aa h a",
    "lkn": ["l aa k i0 nn a", "l aa k i1 n"],
    "lknh": "l aa k i0 nn a h u0",
    "lknhm": "l aa k i0 nn a h u1 m",
    "lknk": ["l aa k i0 nn a k a", "l aa k i0 nn a k i0"],
    "lknkm": "l aa k i0 nn a k u1 m",
    "lknkmA": "l aa k i0 nn a k u0 m aa",
    "lknnA": "l aa k i0 nn a n aa",
    "AlrHmn": ["rr a H m aa n i0", "rr a H m aa n"],
    "Allh": ["ll aa h i0", "ll aa h", "ll AA h u0", "ll AA h a", "ll AA h",
             "ll A"],
    "h*yn": ["h aa * a y n i0", "h aa * a y n"],
    "nt": "n i1 t",
    "fydyw": "v i0 d y uu1",
    "lndn": "l A n d u1 n",
}

_SKELETON_RE = re.compile(r"[^h*Ahn'>wl}kmyTtfd]")

# Ordered literal rewrites applied before the regex normalization rules.
_LITERAL_REWRITES = [
    ("AF", "F"),      # tanween fath after alif
    ("\u0640", ""),   # tatweel
    ("o", ""),        # sukun carries no phone
    ("aA", "A"),
    ("aY", "Y"),
    (" A", " "),      # drop bare word-initial alif (non-first words)
    ("F", "an"),      # expand tanween
    ("N", "un"),
    ("K", "in"),
    ("|", ">A"),      # madda
    ("i~", "~i"),     # shadda before its vowel
    ("a~", "~a"),
    ("u~", "~u"),
]

_REGEX_REWRITES = [
    (re.compile("Ai"), "<i"),
    (re.compile("Aa"), ">a"),
    (re.compile("Au"), ">u"),
    # hamza forms get their implied short vowel when none is written
    (re.compile("^>([^auAw])"), r">a\1"),
    (re.compile(" >([^auAw ])"), r" >a\1"),
    (re.compile("<([^i])"), r"<i\1"),
    # detach trailing punctuation into its own word
    (re.compile(r"(\S)(\.|\?|,|!)"), r"\1 \2"),
]


def normalize_utterance(utterance: str) -> list[str]:
    """Normalize a Buckwalter utterance and split it into words."""
    for old, new in _LITERAL_REWRITES:
        utterance = utterance.replace(old, new)
    for pat, repl in _REGEX_REWRITES:
        utterance = pat.sub(repl, utterance)
    return utterance.split(" ")


# ---------------------------------------------------------------------------
# Fixed-word lexicon
# ---------------------------------------------------------------------------

def fixed_word_pronunciations(word: str) -> list[list[str]]:
    """Pronunciations from the irregular-word lexicon (possibly empty).

    The lexicon is keyed on the word's consonant skeleton; candidate
    pronunciations are filtered by compatibility of their final phone with the
    word's final written letter.
    """
    skeleton = _SKELETON_RE.sub("", word)
    entry = FIXED_WORDS.get(skeleton)
    if entry is None:
        return []
    if isinstance(entry, str):
        return [entry.split(" ")]

    last = word[-1] if word else ""
    # Acceptable final phones implied by the final written letter.  A plain
    # string acts as a substring-membership test (upstream semantics).
    final_ok: list[str] | str
    if last == "a":
        final_ok = ["a", "A"]
    elif last == "A":
        final_ok = ["aa"]
    elif last == "u":
        final_ok = ["u0"]
    elif last == "i":
        final_ok = ["i0"]
    elif last in SIMPLE_CONSONANTS:
        final_ok = [SIMPLE_CONSONANTS[last]]
    else:
        final_ok = last

    out = []
    for pron in entry:
        if pron.split(" ")[-1] in final_ok:
            out.append(pron.split(" "))
    return out


# ---------------------------------------------------------------------------
# Per-word rule pass
# ---------------------------------------------------------------------------

Phone = str
Slot = "Phone | list[Phone]"


def _word_slots(word: str) -> list:
    """Run the MSA rule set over one word.

    Returns a list of slots; each slot is a phone string or a list of
    alternative phones ('' meaning the slot may be omitted).
    """
    # Pad with sentinels so every position has two letters of context on
    # each side ('b' = begin, 'e' = end).
    w = "bb" + word + "ee"
    long_word = len(w) > 7  # original word longer than 3 letters
    emphatic = False
    slots: list = []

    for i in range(2, len(w) - 2):
        p2, p1, c, n1, n2 = w[i - 2], w[i - 1], w[i], w[i + 1], w[i + 2]

        # --- emphatic-context tracking -------------------------------------
        if c in CONSONANT_LETTERS or c in "wy":
            if c not in EMPHATICS:
                emphatic = False  # (includes l/r; see module docstring)
        if c in EMPHATICS:
            emphatic = True
        if n1 in EMPHATICS and n1 not in FORWARD_EMPHATICS:
            emphatic = True
        e = int(emphatic)

        # --- consonants ----------------------------------------------------
        if c in SIMPLE_CONSONANTS:
            slots.append(SIMPLE_CONSONANTS[c])

        if c == "l":
            # lam of the definite article is silent before a sun letter
            # (next letter carries shadda with no written vowel on the lam)
            if n1 not in DIACRITICS and n1 not in VOWEL_TABLE and n2 == "~":
                slots.append("")
            else:
                slots.append("l")

        if c == "~" and p1 not in "wy" and slots:
            # shadda geminates the previous phone
            slots[-1] = slots[-1] + slots[-1]

        if c == "|":
            slots.append(MADDA_EMPHATIC if emphatic else MADDA_PLAIN)

        if c == "p":
            # ta marbuta: /t/ when vowelled, silent at utterance-final pause
            slots.append("t" if n1 in DIACRITICS else "")

        # --- vowels and glides ---------------------------------------------
        if c in "wy":
            glide_long = VOWEL_TABLE[c][e]
            consonantish = (
                n1 in SHORT_DIACRITICS or n1 in "AY"
                or (n1 in "wy" and n2 not in DIACRITICS and n2 not in "Awy")
                or (p1 in SHORT_DIACRITICS
                    and (n1 in CONSONANT_LETTERS or n1 == "e"))
            )
            if consonantish:
                is_long = (
                    (c == "w" and p1 == "u" and n1 not in "aiAY")
                    or (c == "y" and p1 == "i" and n1 not in "auAY")
                )
                if is_long:
                    slots.append(glide_long[0])
                elif c == "w" and n1 == "A" and n2 == "e":
                    slots.append([c, VOWEL_TABLE[c][0][0]])
                else:
                    slots.append(c)
            elif n1 == "~":
                if (p1 == "a" or (c == "w" and p1 in "iy")
                        or (c == "y" and p1 in "wu")):
                    slots.append(c)
                    slots.append(c)
                else:
                    slots.append(VOWEL_TABLE[c][0][0])
                    slots.append(c)
            else:
                # word-final long vowels may shorten
                if (p1 in CONSONANT_LETTERS or p1 in "ui") and n1 == "e":
                    slots.append([glide_long[0], glide_long[0][1:]])
                else:
                    slots.append(glide_long[0])

        if c in "ui":
            # kasra/damma milden before a word-final unvowelled consonant
            milden = (
                (n1 in SIMPLE_CONSONANTS or n1 == "l")
                and n2 == "e" and long_word
            )
            slots.append(VOWEL_TABLE[c][e][1 if milden else 0])

        if c in "aAY":
            if c == "A" and p1 in "wk" and p2 == "b":
                # word-initial wA/kA cluster: short or long /a/
                slots.append(["a", LONG_A[0]])
            elif c == "A" and p1 in "ui":
                pass  # silent alif after damma/kasra
            elif c == "A" and p1 == "w" and n1 == "e":
                # waw al-jama'a: trailing alif optional
                slots.append(list(LONG_A))
            elif c in "AY" and n1 == "e":
                tbl = VOWEL_TABLE[c][e]
                slots.append([tbl[0], VOWEL_TABLE["a"][e]])
            else:
                slots.append(VOWEL_TABLE[c][e][0])

    return slots


def _expand_slots(slots: list) -> list[list[str]]:
    """Expand branch-point slots into the full set of pronunciations."""
    count = 1
    for slot in slots:
        if isinstance(slot, list):
            count *= len(slot)

    prons: list[list[str]] = []
    for pick in range(count):
        pron: list[str] = []
        stride = 1
        for slot in slots:
            if isinstance(slot, list):
                phone = slot[(pick // stride) % len(slot)]
                stride *= len(slot)
            else:
                phone = slot
            if phone:
                pron.append(phone)
        prons.append(pron)
    return prons


def _cleanup(pron: list[str]) -> list[str]:
    """Merge duplicate adjacent vowels/glides left by the rule pass."""
    drop: list[int] = []
    prev = ""
    for i, phone in enumerate(pron):
        if (phone in ("aa", "uu0", "ii0", "AA", "UU0", "II0")
                and prev.lower() == phone[1:].lower()):
            drop.append(i - 1)
            pron[i] = pron[i - 1][0] + pron[i - 1]
        if phone in ("u0", "i0") and prev.lower() == phone.lower():
            drop.append(i - 1)
            pron[i] = pron[i - 1]
        if phone in ("y", "w") and prev == phone:
            pron[i - 1] = pron[i - 1] + pron[i - 1]
            drop.append(i)
        prev = phone
    for i in reversed(drop):
        del pron[i]
    return pron


def phonetise_word(word: str) -> list[list[str]] | str:
    """All candidate pronunciations of one word (lexicon first), or the word
    itself if it is punctuation."""
    if word in PUNCTUATION:
        return word
    prons = fixed_word_pronunciations(word)
    prons += _expand_slots(_word_slots(word))
    return [_cleanup(p) for p in prons]


@functools.lru_cache(maxsize=1 << 16)
def _best_pronunciation(word: str) -> tuple[str, ...] | str:
    result = phonetise_word(word)
    return result if isinstance(result, str) else tuple(result[0])


def clear_word_cache() -> None:
    """Forget every pronunciation `process_word` keeps (for timing text
    whose words were not met before)."""
    _best_pronunciation.cache_clear()


def process_word(word: str) -> list[str] | str:
    """Best pronunciation of one word (reference-API name). A word's
    pronunciation depends on the word alone, so those of the last 65,536
    distinct words are kept: the rule pass costs ~13 us a word, and
    running text repeats many of its words."""
    best = _best_pronunciation(word)
    return best if isinstance(best, str) else list(best)


def process_utterance(utterance: str) -> str:
    """Phonetise a Buckwalter utterance.

    Words are joined with ' + ' separators; 'sil'/'-' map to silence;
    punctuation attaches to the preceding word.
    """
    words: list[list[str]] = []
    for word in normalize_utterance(utterance):
        if word in ("-", "sil"):
            words.append(["sil"])
            continue
        pron = process_word(word)
        if isinstance(pron, str) and pron in PUNCTUATION and words:
            words[-1] = words[-1] + [pron]
        else:
            words.append(pron if isinstance(pron, list) else [pron])
    return " + ".join(" ".join(w) for w in words)
