"""Strict and tolerant parsers for wire-derived numbers.

Plain ``int()`` accepts ``'+5'``, ``' 5 '``, ``'1_0'`` and unicode digits
(``'²'`` makes ``isdigit()`` and ``int()`` disagree). Request handlers parse
query integers through these instead.
"""

from __future__ import annotations

import math
from typing import Optional


def parse_ascii_uint(s: str) -> int:
    """Strict non-negative decimal: ascii digits only, raises ValueError."""
    if not isinstance(s, str) or not (s.isascii() and s.isdigit()):
        raise ValueError(f"not a non-negative integer: {s!r}")
    return int(s)


def tolerant_uint(raw, default: Optional[int]) -> Optional[int]:
    """Tolerant non-negative decimal: garbage and negatives fall back to
    ``default`` (the reference's handlers ignore strconv.Atoi failures)."""
    if isinstance(raw, int):
        return raw if raw >= 0 else default
    try:
        return parse_ascii_uint(raw)
    except ValueError:
        return default


def tolerant_ufloat(raw, default: float) -> float:
    """Tolerant non-negative float: garbage, negatives and non-finite values
    fall back to ``default`` (a NaN deadline busy-loops ``Condition.wait``;
    an inf timeout never expires)."""
    try:
        val = float(raw)
    except (TypeError, ValueError):
        return default
    if not math.isfinite(val) or val < 0:
        return default
    return val
