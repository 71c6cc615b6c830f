"""Query evaluation over CSV / JSON-lines blobs.

Filter spec: {"field": "a.b", "op": "=", "value": x} — ops =, !=, <, <=, >,
>=, contains, starts_with, like. Projection: list of (dotted) field names or
["*"]. Mirrors the semantics of `volume_grpc_query.go` (gjson path lookup +
the same operator set) without the SQL front-end.

The ``like`` value is a canonical SQL LIKE pattern: ``%`` matches any run
(including across newlines), ``_`` matches one character, and ``\\`` escapes
the next character; the whole value must match. The SQL front-end emits
this op only for patterns its contains/starts_with/equality translations
cannot express.

This row-at-a-time evaluator is the semantic oracle for the vectorized
plans in ``scan.py`` — every behavior here, including the coercion corner
cases, is mirrored there kernel-side or routed to this module's functions
through the per-row exact lane.
"""

from __future__ import annotations

import csv
import io
import json
import re
from typing import Any, Optional


def _get_path(doc: dict, path: str) -> Any:
    cur: Any = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list):
            # ascii-digits only: "-1" must not slice from the tail, and
            # unicode digits ("١٢" passes str.isdigit) must not index
            if not (part.isascii() and part.isdigit()):
                return None
            idx = int(part)
            cur = cur[idx] if 0 <= idx < len(cur) else None
        else:
            return None
    return cur


def _coerce_pair(a: Any, b: Any) -> tuple[Any, Any]:
    """Compare numerically when both sides look numeric.

    JSON booleans are NOT numbers here: float(True) == 1.0 made
    ``WHERE flag = 1`` match ``{"flag": true}``; a bool on either side
    forces bool/string comparison instead."""
    if isinstance(a, bool) or isinstance(b, bool):
        if isinstance(a, bool) and isinstance(b, bool):
            return a, b
        return str(a), str(b)
    try:
        return float(a), float(b)
    except (TypeError, ValueError):
        return str(a), str(b)


_LIKE_CACHE: dict[str, "re.Pattern[str]"] = {}


def _like_regex(pattern: str) -> "re.Pattern[str]":
    """Canonical LIKE pattern → anchored regex (cached; patterns come from
    parsed SQL, so the cache is bounded by distinct queries seen)."""
    rx = _LIKE_CACHE.get(pattern)
    if rx is not None:
        return rx
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
        elif c == "%":
            out.append(".*")
            i += 1
        elif c == "_":
            out.append(".")
            i += 1
        else:
            out.append(re.escape(c))
            i += 1
    rx = re.compile("(?s)" + "".join(out) + r"\Z")
    if len(_LIKE_CACHE) < 1024:
        _LIKE_CACHE[pattern] = rx
    return rx


def _matches(doc: dict, flt: Optional[dict]) -> bool:
    if not flt:
        return True
    # compound filters from the SQL front-end: {"and": [...]} / {"or": [...]}
    # / {"not": {...}} nest arbitrarily around leaf comparisons
    if "and" in flt:
        return all(_matches(doc, f) for f in flt["and"])
    if "or" in flt:
        return any(_matches(doc, f) for f in flt["or"])
    if "not" in flt:
        return not _matches(doc, flt["not"])
    got = _get_path(doc, flt.get("field", ""))
    op = flt.get("op", "=")
    want = flt.get("value")
    if op in ("contains", "starts_with"):
        s, w = str(got or ""), str(want or "")
        return s.find(w) >= 0 if op == "contains" else s.startswith(w)
    if got is None:
        return False
    if op == "like":
        return _like_regex(str(want)).match(str(got)) is not None
    a, b = _coerce_pair(got, want)
    if op == "=":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ValueError(f"unknown op {op!r}")


def _project(doc: dict, select: Optional[list[str]]) -> dict:
    if not select or select == ["*"]:
        return doc
    return {f: _get_path(doc, f) for f in select}


def _iter_docs(data: bytes, input_format: str):
    if input_format == "csv":
        text = data.decode("utf-8", errors="replace")
        yield from csv.DictReader(io.StringIO(text))
        return
    # json: one object per line, or a single array/object
    text = data.decode("utf-8", errors="replace").strip()
    if text.startswith("["):
        for doc in json.loads(text):
            yield doc
        return
    for line in text.splitlines():
        line = line.strip()
        if line:
            yield json.loads(line)


def run_query(
    data: bytes,
    input_format: str = "json",
    select: Optional[list[str]] = None,
    where: Optional[dict] = None,
    limit: int = 0,
) -> list[dict]:
    out = []
    for doc in _iter_docs(data, input_format):
        if _matches(doc, where):
            out.append(_project(doc, select))
            if limit and len(out) >= limit:
                break
    return out
