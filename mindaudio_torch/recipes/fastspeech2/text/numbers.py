"""Number → English words expansion (the port's copy of the JAX recipe's
``text/numbers.py``, self-contained — no ``inflect``)."""

from __future__ import annotations

import re

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
           (10**2, "hundred")]

_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_ordinal_re = re.compile(r"([0-9]+)(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _int_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + _int_to_words(-n)
    words = []
    for scale, name in _SCALES:
        if n >= scale:
            words.append(_int_to_words(n // scale))
            words.append(name)
            n %= scale
    if n >= 20:
        words.append(_TENS[n // 10])
        if n % 10:
            words.append(_ONES[n % 10])
    elif n > 0:
        words.append(_ONES[n])
    return " ".join(w for w in words if w)


def _expand_decimal(m):
    intpart, frac = m.group(1).split(".")
    digits = " ".join(_ONES[int(d)] if d != "0" else "zero" for d in frac)
    return f"{_int_to_words(int(intpart))} point {digits}"


def _expand_dollars(m):
    parts = m.group(1).replace(",", "").split(".")
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1][:2].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    out = []
    if dollars:
        out.append(f"{_int_to_words(dollars)} dollar{'s' if dollars != 1 else ''}")
    if cents:
        out.append(f"{_int_to_words(cents)} cent{'s' if cents != 1 else ''}")
    return ", ".join(out) or "zero dollars"


def _expand_ordinal(m):
    n = int(m.group(1))
    words = _int_to_words(n)
    specials = {"one": "first", "two": "second", "three": "third",
                "five": "fifth", "eight": "eighth", "nine": "ninth",
                "twelve": "twelfth"}
    head, _, last = words.rpartition(" ")
    if last in specials:
        last = specials[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def _expand_number(m):
    """Plain numbers; 1000 < n < 3000 read as years ("nineteen ninety nine"),
    matching the reference cleaner's convention (numbers.py:_expand_number)."""
    n = int(m.group(0))
    if 1000 < n < 3000:
        if n == 2000:
            return "two thousand"
        if 2000 < n < 2010:
            return "two thousand " + _int_to_words(n % 100)
        if n % 100 == 0:
            return _int_to_words(n // 100) + " hundred"
        tail = _int_to_words(n % 100) if n % 100 else ""
        if n % 100 < 10 and n % 100 > 0:
            tail = "oh " + tail
        return f"{_int_to_words(n // 100)} {tail}".strip()
    return _int_to_words(n)


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(lambda m: f"{_int_to_words(int(m.group(1).replace(',', '')))} pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_re.sub(_expand_decimal, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
