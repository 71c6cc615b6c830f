"""TPC-H ``lineitem`` rows as CSV, from a seed (TPC-H 3.0.1, section 4.2.3).

Each object is a CSV of its own: a header line of the 16 column names, then
rows with ``,`` between fields and LF line ends, no quoting (the grammar of
TPC-H's text has no commas). Orders follow section 4.2.3 at scale factor 1:
sparse order keys (8 used in each 32), 1-7 lines an order, part keys in
1..200 000, supplier keys by the spec's formula, quantity 1..50, the
extended price from the part's retail price, discount 0.00-0.10, tax
0.00-0.08, ship, commit and receipt dates from an order date in
1992-01-01..1998-08-02, return flag and line status against 1995-06-17, and
the ship instructions and modes of section 4.2.2.13. Comments are slices of
10-43 characters of a text pool made from the words of section 4.2.2.10
(the pool's grammar here is a simplified one: ``assumed`` in the
configuration).

Rows are built as one byte matrix and a mask of the bytes each keeps, so
32 MiB of CSV takes well under a second.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
           "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
           "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct", "l_shipmode",
           "l_comment")
SF_PARTS, SF_SUPPLIERS = 200_000, 10_000
START, CURRENT, END = np.datetime64("1992-01-01"), np.datetime64("1995-06-17"), \
    np.datetime64("1998-12-31")
INSTRUCTIONS = (b"DELIVER IN PERSON", b"COLLECT COD", b"NONE", b"TAKE BACK RETURN")
MODES = (b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB")
ORDERS_PER_OBJECT = 72_000  # enough rows for 32 MiB; cut to whole rows

NOUNS = ("foxes ideas theodolites pinto beans instructions dependencies excuses platelets "
         "asymptotes courts dolphins multipliers sauternes warthogs frets dinos attainments "
         "somas Tiresias patterns forges braids hockey players frays warhorses dugouts "
         "notornis epitaphs pearls tithes waters orbits gifts sheaves depths sentiments "
         "decoys realms pains grouches escapades").split()
VERBS = ("sleep wake are cajole haggle nag use boost affix detect integrate maintain nod was "
         "lose sublate solve thrash promise engage hinder print x-ray breach eat grow impress "
         "mold poach serve run dazzle snooze doze unwind kindle play hang believe doubt").split()
ADJECTIVES = ("furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged "
              "daring brave stealthy permanent enticing idle busy regular final ironic even "
              "bold silent").split()
ADVERBS = ("sometimes always never furiously slyly carefully blithely quickly fluffily slowly "
           "quietly ruthlessly thinly closely doggedly daringly bravely stealthily "
           "permanently enticingly idly busily regularly finally ironically evenly boldly "
           "silently").split()
PREPOSITIONS = ("about above across after against along among around at atop before behind "
                "beneath beside besides between beyond by despite during except for from "
                "inside into near of on outside over past since through throughout to toward "
                "under until up upon without with within").split()
TERMINATORS = (".", ";", ":", "?", "!", "--")


def text_pool(seed: int, sentences: int = 8192) -> np.ndarray:
    """Sentences of TPC-H's words: [adjective] noun verb [adverb]
    [preposition the noun] terminator; about 330 KiB."""
    rng = np.random.default_rng([seed, 1 << 20])
    coin = rng.random((sentences, 3)) < 0.5
    pick = [rng.integers(0, len(t), sentences) for t in
            (ADJECTIVES, NOUNS, VERBS, ADVERBS, PREPOSITIONS, NOUNS, TERMINATORS)]
    out = []
    for i in range(sentences):
        words = [ADJECTIVES[pick[0][i]]] if coin[i, 0] else []
        words += [NOUNS[pick[1][i]], VERBS[pick[2][i]]]
        if coin[i, 1]:
            words.append(ADVERBS[pick[3][i]])
        if coin[i, 2]:
            words += [PREPOSITIONS[pick[4][i]], "the", NOUNS[pick[5][i]]]
        out.append(" ".join(words) + TERMINATORS[pick[6][i]] + " ")
    return np.frombuffer("".join(out).encode(), np.uint8)


def _digits(v: np.ndarray, width: int, strip: bool = True):
    """ASCII digits of ``v`` in ``width`` columns, with a mask that keeps
    them all or (``strip``) drops the leading zeros."""
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    mat = ((v[:, None] // pw) % 10 + 48).astype(np.uint8)
    keep = (v[:, None] >= pw) | (pw == 1) if strip else np.ones(mat.shape, dtype=bool)
    return mat, keep


def _const(n: int, b: bytes):
    return (np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b))),
            np.ones((n, len(b)), dtype=bool))


def _choice(idx: np.ndarray, table: tuple):
    w = max(len(t) for t in table)
    tab = np.zeros((len(table), w), dtype=np.uint8)
    for i, t in enumerate(table):
        tab[i, :len(t)] = np.frombuffer(t, np.uint8)
    lens = np.array([len(t) for t in table])
    return tab[idx], np.arange(w)[None, :] < lens[idx][:, None]


_DATES = np.datetime_as_string(START + np.arange(int((END - START).astype(int)) + 160)
                                .astype("timedelta64[D]"), unit="D").astype("S10").view(
    np.uint8).reshape(-1, 10)


def _date(days: np.ndarray):
    return _DATES[days], np.ones((len(days), 10), dtype=bool)


def _cents(v: np.ndarray, int_width: int):
    i, f = _digits(v // 100, int_width), _digits(v % 100, 2, strip=False)
    dot = _const(len(v), b".")
    return np.concatenate([i[0], dot[0], f[0]], 1), np.concatenate([i[1], dot[1], f[1]], 1)


def lineitem_csv(seed: int, index: int, size: int) -> bytes:
    """Object ``index`` of the table for ``seed``: the rows of orders
    ``index * ORDERS_PER_OBJECT`` on, cut to the whole rows under ``size``
    bytes, header included."""
    rng = np.random.default_rng([seed, index])
    pool = text_pool(seed)
    first = index * ORDERS_PER_OBJECT
    nlines = rng.integers(1, 8, ORDERS_PER_OBJECT)
    order = np.repeat(np.arange(first, first + ORDERS_PER_OBJECT), nlines)
    n = len(order)
    line = np.arange(n) - np.repeat(np.cumsum(nlines) - nlines, nlines) + 1
    orderkey = order // 8 * 32 + order % 8 + 1
    orderdate = np.repeat(rng.integers(0, int((END - START).astype(int)) - 151 + 1,
                                       ORDERS_PER_OBJECT), nlines)
    partkey = rng.integers(1, SF_PARTS + 1, n)
    s = SF_SUPPLIERS
    suppkey = (partkey + rng.integers(0, 4, n) * (s // 4 + (partkey - 1) // s)) % s + 1
    quantity = rng.integers(1, 51, n)
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    price = quantity * retail_cents
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    ship = orderdate + rng.integers(1, 122, n)
    commit = orderdate + rng.integers(30, 91, n)
    receipt = ship + rng.integers(1, 31, n)
    current = int((CURRENT - START).astype(int))
    flag = np.where(receipt <= current, rng.integers(0, 2, n), 2)  # R, A; else N
    status = (ship > current).astype(np.int64)  # O when shipped after CURRENTDATE
    comment_len = rng.integers(10, 44, n)
    comment_at = rng.integers(0, len(pool) - 44, n)
    cmat = pool[comment_at[:, None] + np.arange(43)[None, :]]
    ckeep = np.arange(43)[None, :] < comment_len[:, None]
    comma = _const(n, b",")
    cols = [_digits(orderkey, 9), _digits(partkey, 6), _digits(suppkey, 5), _digits(line, 1),
            _digits(quantity, 2), _cents(price, 6), _cents(discount, 1), _cents(tax, 1),
            _choice(flag, (b"R", b"A", b"N")), _choice(status, (b"F", b"O")),
            _date(ship), _date(commit), _date(receipt), _choice(rng.integers(0, 4, n),
                                                               INSTRUCTIONS),
            _choice(rng.integers(0, 7, n), MODES), (cmat, ckeep)]
    parts = []
    for i, c in enumerate(cols):
        if i:
            parts.append(comma)
        parts.append(c)
    parts.append(_const(n, b"\n"))
    mat = np.concatenate([p[0] for p in parts], axis=1)
    keep = np.concatenate([p[1] for p in parts], axis=1)
    data = (",".join(COLUMNS).encode() + b"\n" + mat[keep].tobytes())[:size]
    return data[: data.rfind(b"\n") + 1]
