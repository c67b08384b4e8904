"""Small English morphology helpers (pluralize / singularize / articles / numbers).

The reference depends on the `inflect` package for these (utils/parse.py:7-10,
utils/eval/utils.py:2-5). `inflect` is not available in this environment, and
the needed surface is tiny and closed over the benchmark vocabulary, so we
implement it directly. The benchmark golden tests (tests/test_eval_prompts.py)
verify exact string parity with the reference's generated prompt set.
"""

from __future__ import annotations

# Irregular plurals worth knowing about for open-vocabulary LLM layouts.
_IRREGULAR_PLURALS = {
    "person": "people",
    "man": "men",
    "woman": "women",
    "child": "children",
    "foot": "feet",
    "tooth": "teeth",
    "goose": "geese",
    "mouse": "mice",
    "ox": "oxen",
    "sheep": "sheep",
    "deer": "deer",
    "fish": "fish",
    "leaf": "leaves",
    "loaf": "loaves",
    "knife": "knives",
    "wife": "wives",
    "wolf": "wolves",
    "shelf": "shelves",
    "scarf": "scarves",
    "die": "dice",
    "cactus": "cacti",
}
_IRREGULAR_SINGULARS = {v: k for k, v in _IRREGULAR_PLURALS.items() if v != k}

_VOWELS = "aeiou"


def pluralize_word(word: str) -> str:
    """Pluralize a single noun."""
    lower = word.lower()
    if lower in _IRREGULAR_PLURALS:
        out = _IRREGULAR_PLURALS[lower]
        return out.capitalize() if word[:1].isupper() else out
    if lower.endswith(("s", "x", "z", "ch", "sh")):
        return word + "es"
    if lower.endswith("y") and len(lower) > 1 and lower[-2] not in _VOWELS:
        return word[:-1] + "ies"
    if lower.endswith("o") and lower not in ("photo", "piano", "halo", "avocado", "taco"):
        # tomato -> tomatoes, but photo -> photos
        return word + "es"
    return word + "s"


def pluralize(phrase: str) -> str:
    """Pluralize the last word of a noun phrase ('blue cube' -> 'blue cubes')."""
    parts = phrase.split(" ")
    parts[-1] = pluralize_word(parts[-1])
    return " ".join(parts)


def singularize_word(word: str) -> str:
    lower = word.lower()
    if lower in _IRREGULAR_SINGULARS:
        out = _IRREGULAR_SINGULARS[lower]
        return out.capitalize() if word[:1].isupper() else out
    if lower.endswith("ies") and len(lower) > 3:
        return word[:-3] + "y"
    if lower.endswith(("ches", "shes", "xes", "sses", "zes")):
        return word[:-2]
    if lower.endswith("oes"):
        return word[:-2]
    if lower.endswith("s") and not lower.endswith("ss") and not lower.endswith("us"):
        return word[:-1]
    return word


def singularize(phrase: str) -> str:
    """Singularize the last word of a noun phrase; identity if already singular."""
    parts = phrase.split(" ")
    parts[-1] = singularize_word(parts[-1])
    return " ".join(parts)


_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty", "ninety"]


def number_to_words(n: int) -> str:
    """Spell out 0..99 ('two', 'twenty-one'). Larger numbers stay digits."""
    if 0 <= n < 20:
        return _ONES[n]
    if 20 <= n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] if ones == 0 else f"{_TENS[tens]}-{_ONES[ones]}"
    return str(n)


WORD_TO_NUM = {number_to_words(i): i for i in range(1, 21)}

# Words whose spelling starts with a vowel but take "a" (vowel letter,
# consonant sound), and vice versa.
_A_EXCEPTIONS = ("uni", "use", "usu", "one", "euro", "ewe", "ufo", "url")
_AN_EXCEPTIONS = ("hour", "honest", "honor", "heir", "x-", "mri", "sos")


def article(phrase: str) -> str:
    """Indefinite article ('a' / 'an') for a noun phrase."""
    first = phrase.split(" ")[0].lower()
    if first.startswith(_AN_EXCEPTIONS):
        return "an"
    if first.startswith(_A_EXCEPTIONS):
        return "a"
    return "an" if first[:1] in _VOWELS else "a"


def a(phrase: str) -> str:
    """Prefix a noun phrase with its indefinite article ('apple' -> 'an apple')."""
    return f"{article(phrase)} {phrase}"
