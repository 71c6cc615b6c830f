r"""SQL front-end for the query engine — the piece the reference left
unfinished (`weed/query/sqltypes` has the value model but no parser wired
to `volume_grpc_query.go`; S3 Select clients expect
`SELECT ... FROM s3object WHERE ...`).

Grammar (S3-Select subset):

    SELECT * | field[, field...]         (dotted paths allowed)
    FROM <ident>                          (table name is cosmetic)
    [WHERE <expr>]                        (=, !=, <>, <, <=, >, >=,
                                           LIKE with full %/_ wildcards and
                                           \%/\_ escapes, NOT, AND, OR,
                                           parentheses; string/number
                                           literals; single or double quotes)
    [LIMIT <n>]                           (strict ascii uint)

`parse_sql` compiles to the engine's filter dict ({"and": [...]} etc.), so
evaluation stays in one place (engine._matches).
"""

from __future__ import annotations

import re
from typing import Any, Optional

from ..util.parsers import parse_ascii_uint
from .engine import run_query

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<num>-?\d+(?:\.\d+)?)
      | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<op><=|>=|!=|<>|=|<|>)
      | (?P<punct>[(),*])
      | (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {"select", "from", "where", "limit", "and", "or", "not", "like"}


class SqlError(ValueError):
    pass


def _tokenize(sql: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN.match(sql, pos)
        if m is None:
            if sql[pos:].strip() == "":
                break
            raise SqlError(f"bad token at {sql[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group(kind)
        if kind == "word" and text.lower() in _KEYWORDS:
            out.append(("kw", text.lower()))
        else:
            out.append((kind, text))
    return out


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self) -> tuple[str, str]:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> str:
        k, v = self.next()
        if k != kind or (text is not None and v != text):
            raise SqlError(f"expected {text or kind}, got {v!r}")
        return v

    # -- SELECT ... FROM ... [WHERE ...] [LIMIT n] ---------------------------
    def parse(self) -> tuple[Optional[list], Optional[dict], int]:
        self.expect("kw", "select")
        select = self._projection()
        self.expect("kw", "from")
        self.expect("word")  # table name — cosmetic (s3object)
        where = None
        limit = 0
        if self.peek() == ("kw", "where"):
            self.next()
            where = self._or_expr()
        if self.peek() == ("kw", "limit"):
            self.next()
            text = self.expect("num")
            try:
                # the shared strict wire parser: ascii digits only, so
                # "-5", "2.5", "+3" and "1_0" all fail the same way
                limit = parse_ascii_uint(text)
            except ValueError:
                raise SqlError(
                    f"LIMIT must be a non-negative integer: {text}"
                ) from None
        if self.peek()[0] != "eof":
            raise SqlError(f"trailing input at {self.peek()[1]!r}")
        return select, where, limit

    def _projection(self) -> Optional[list]:
        if self.peek() == ("punct", "*"):
            self.next()
            return None  # engine treats None as all fields
        fields = [self.expect("word")]
        while self.peek() == ("punct", ","):
            self.next()
            fields.append(self.expect("word"))
        return fields

    # -- boolean expression (OR lowest, then AND, NOT, atoms) ----------------
    def _or_expr(self) -> dict:
        terms = [self._and_expr()]
        while self.peek() == ("kw", "or"):
            self.next()
            terms.append(self._and_expr())
        return terms[0] if len(terms) == 1 else {"or": terms}

    def _and_expr(self) -> dict:
        terms = [self._not_expr()]
        while self.peek() == ("kw", "and"):
            self.next()
            terms.append(self._not_expr())
        return terms[0] if len(terms) == 1 else {"and": terms}

    def _not_expr(self) -> dict:
        if self.peek() == ("kw", "not"):
            self.next()
            return {"not": self._not_expr()}
        return self._atom()

    def _atom(self) -> dict:
        if self.peek() == ("punct", "("):
            self.next()
            inner = self._or_expr()
            self.expect("punct", ")")
            return inner
        field = self.expect("word")
        kind, op = self.next()
        if (kind, op) == ("kw", "like"):
            return self._like(field)
        if kind != "op":
            raise SqlError(f"expected comparison after {field!r}, got {op!r}")
        value = self._literal()
        if op == "<>":
            op = "!="
        return {"field": field, "op": op, "value": value}

    def _like(self, field: str) -> dict:
        # take the RAW quoted body: _literal()'s general unescape would
        # collapse \% / \_ into bare wildcards before we can see them
        kind, text = self.next()
        if kind != "str":
            raise SqlError("LIKE needs a string pattern")
        body = text[1:-1]
        atoms: list[tuple] = []  # ("lit", ch) | ("any",) | ("one",)
        i = 0
        while i < len(body):
            c = body[i]
            if c == "\\" and i + 1 < len(body):
                atoms.append(("lit", body[i + 1]))
                i += 2
            elif c == "%":
                atoms.append(("any",))
                i += 1
            elif c == "_":
                atoms.append(("one",))
                i += 1
            else:
                atoms.append(("lit", c))
                i += 1
        lits = "".join(a[1] for a in atoms if a[0] == "lit")
        # the engine's substring ops cover the common S3-Select shapes
        # (and are the ones the scan kernels vectorize): %x% → contains,
        # x% → starts_with, no wildcards → equals; anything else compiles
        # to the general "like" op in canonical escaped form
        if all(a[0] == "lit" for a in atoms):
            return {"field": field, "op": "=", "value": lits}
        if (
            len(atoms) >= 2
            and atoms[0] == ("any",)
            and atoms[-1] == ("any",)
            and all(a[0] == "lit" for a in atoms[1:-1])
        ):
            return {"field": field, "op": "contains", "value": lits}
        if atoms[-1] == ("any",) and all(a[0] == "lit" for a in atoms[:-1]):
            return {"field": field, "op": "starts_with", "value": lits}
        canonical = []
        for a in atoms:
            if a[0] == "any":
                canonical.append("%")
            elif a[0] == "one":
                canonical.append("_")
            elif a[1] in "\\%_":
                canonical.append("\\" + a[1])
            else:
                canonical.append(a[1])
        return {"field": field, "op": "like", "value": "".join(canonical)}

    def _literal(self) -> Any:
        kind, text = self.next()
        if kind == "num":
            return float(text) if "." in text else int(text)
        if kind == "str":
            body = text[1:-1]
            return re.sub(r"\\(.)", r"\1", body)
        raise SqlError(f"expected literal, got {text!r}")


def parse_sql(sql: str) -> tuple[Optional[list], Optional[dict], int]:
    """SQL text → (select, where, limit) in the engine's filter language."""
    return _Parser(_tokenize(sql)).parse()


def run_sql(
    data: bytes, sql: str, input_format: str = "json"
) -> list[dict]:
    select, where, limit = parse_sql(sql)
    return run_query(
        data, input_format=input_format, select=select, where=where,
        limit=limit,
    )
