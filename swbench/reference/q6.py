"""Plain filter of a ``lineitem`` CSV object by TPC-H Q6's predicate.

S3 Select's semantics as SeaweedFS's volume-server query applies them
(``volume_grpc_query.go``): the first line names the fields; a field and a
literal compare as numbers when both read as numbers, else as strings. So
``l_shipdate`` compares as text, ``l_discount`` and ``l_quantity`` as
float64. The rows selected keep their fields' text.

``float_type`` is the control's switch: the fields read in a narrower
float (``numpy.float32``) against the same literals.
"""

from __future__ import annotations

import hashlib

import numpy as np

PROJECT = ("l_extendedprice", "l_discount")


def sql(p: dict) -> str:
    """Q6's WHERE clause over the parameters ``p``, as the port's SQL reads
    it (no BETWEEN: two bounds with the same meaning)."""
    return (f"SELECT {', '.join(PROJECT)} FROM s3object WHERE "
            f"l_shipdate >= '{p['shipdate_from']}' AND l_shipdate < '{p['shipdate_to']}' "
            f"AND l_discount >= {p['discount_lo']} AND l_discount <= {p['discount_hi']} "
            f"AND l_quantity < {p['quantity_below']}")


def rows(data: bytes, p: dict, float_type=float) -> list:
    """[(l_extendedprice, l_discount)] of the rows Q6 selects, in order."""
    lines = data.decode("utf-8").split("\n")
    names = lines[0].split(",")
    ship, disc, qty = (names.index(n) for n in ("l_shipdate", "l_discount", "l_quantity"))
    out_at = [names.index(n) for n in PROJECT]
    lo, hi = float(p["discount_lo"]), float(p["discount_hi"])
    below = float(p["quantity_below"])
    d_from, d_to = p["shipdate_from"], p["shipdate_to"]
    out = []
    for line in lines[1:]:
        if not line:
            continue
        f = line.split(",")
        if not d_from <= f[ship] < d_to:
            continue
        d = float_type(f[disc])
        if d >= lo and d <= hi and float_type(f[qty]) < below:
            out.append(tuple(f[i] for i in out_at))
    return out


def digest(selected: list) -> str:
    """One digest of a reply's rows, in order, each as its projected text."""
    h = hashlib.sha256()
    for r in selected:
        h.update("\x1f".join(r).encode() + b"\x1e")
    return h.hexdigest()


def narrow(text: str) -> float:
    """The control's reading of a number: float32."""
    return float(np.float32(text))
