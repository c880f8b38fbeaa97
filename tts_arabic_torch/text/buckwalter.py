"""Arabic script <-> Buckwalter transliteration.

Same character correspondence as reference `text/phonetise_buckwalter.py:10-56`,
implemented via `str.translate` tables. Unmapped characters pass through.
"""

# Parallel strings: Arabic codepoints and their Buckwalter ASCII counterparts.
_ARABIC = (
    "بتثجحخدذرز"  # b t ^ j H x d * r z
    "سشصضطظعغفق"  # s $ S D T Z E g f q
    "كلمنهوي"                    # k l m n h w y
    "ءآأؤإئاةى"        # ' | > & < } A p Y
    "ًٌٍَُِّْ"              # F N K a u i ~ o
)
_BUCKWALTER = "bt^jHxd*rzs$SDTZEgfqklmnhwy'|>&<}ApYFNKaui~o"

assert len(_ARABIC) == len(_BUCKWALTER)

_AR2BW = str.maketrans(_ARABIC, _BUCKWALTER)
_BW2AR = str.maketrans(_BUCKWALTER, _ARABIC)


def arabic_to_buckwalter(text: str) -> str:
    """Transliterate Arabic script to Buckwalter ASCII."""
    return text.translate(_AR2BW)


def buckwalter_to_arabic(text: str) -> str:
    """Transliterate Buckwalter ASCII back to Arabic script."""
    return text.translate(_BW2AR)
