"""The port's query engine against the JAX package's, on the CPU.

The port's scan plans (``backend="cpu"``: the same tensor graph the GPU
runs, on CPU tensors) must return exactly what the JAX package's
row-at-a-time ``engine.run_query`` returns, exception type included, on the
adversarial generators of ``tests/test_query_scan.py`` (loaded from that
file, not copied). The port's engine and SQL front-end must agree with the
JAX ones on the same corpus. The tree's primitives must give the JAX
package's numpy primitives' results bit for bit, and its numeric parse must
equal ``float()`` at the edge of its domain. Tolerance: none anywhere; every
comparison is exact.
"""

import csv
import importlib.util
import os
import random
import sys
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.query import engine as jengine
from seaweedfs_tpu.query import scan as jscan
from seaweedfs_tpu.query import sql as jsql
from seaweedfs_tpu_torch.query import engine as pengine
from seaweedfs_tpu_torch.query import execute_request
from seaweedfs_tpu_torch.query import scan as pscan
from seaweedfs_tpu_torch.query import sql as psql
from seaweedfs_tpu_torch.stats.metrics import QUERY_COUNTERS, Counter
from swbench.gen.lineitem import COLUMNS, lineitem_csv

_GEN_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "test_query_scan.py")


def _load_generators():
    spec = importlib.util.spec_from_file_location("_jax_query_scan_generators", _GEN_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEN = _load_generators()


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 — exception parity is the test
        return None, type(e).__name__


def _corpus(seed, trials):
    """(fmt, data, select, where, limit, split) per trial, drawn as the JAX
    test draws them."""
    rng = random.Random(seed)
    for _ in range(trials):
        fmt = rng.choice(["csv", "csv", "json"])
        data = GEN.rand_csv(rng) if fmt == "csv" else GEN.rand_jsonl(rng)
        where = GEN.rand_filter(rng) if rng.random() < 0.9 else None
        select = GEN.rand_select(rng)
        limit = rng.choice([0, 0, 1, 3, 100])
        pieces = None
        if rng.random() < 0.5:
            pieces, pos = [], 0  # arbitrary chunk split points
            while pos < len(data):
                step = rng.randint(1, max(1, len(data) // 3))
                pieces.append(data[pos:pos + step])
                pos += step
        yield fmt, data, select, where, limit, pieces


def _scan(backend, fmt, data, select, where, limit, pieces):
    plan = pscan.compile_plan(select, where, limit, fmt, backend)
    if pieces is None:
        return plan.execute(data)
    return [r for b in plan.scan_iter(iter(pieces)) for r in b]


@pytest.mark.parametrize("seed", [1234, 77, 5, 2024])
def test_scan_equals_the_reference_engine(seed):
    """150 seeded trials per seed (600 in all), whole and chunk-split."""
    for trial, (fmt, data, select, where, limit, pieces) in enumerate(_corpus(seed, 150)):
        ctx = (trial, fmt, select, where, limit, data[:200])
        want = _outcome(lambda: jengine.run_query(data, input_format=fmt, select=select,
                                                  where=where, limit=limit))
        got = _outcome(lambda: _scan("cpu", fmt, data, select, where, limit, pieces))
        if want[1] is None and got[1] is not None:
            raise AssertionError(f"scan raised {got[1]} where the engine did not: {ctx}")
        assert got == want, ctx


@pytest.mark.parametrize("seed", [31, 32])
def test_engine_copy_equals_the_reference_engine(seed):
    for trial, (fmt, data, select, where, limit, _) in enumerate(_corpus(seed, 200)):
        want = _outcome(lambda: jengine.run_query(data, fmt, select, where, limit))
        got = _outcome(lambda: pengine.run_query(data, fmt, select, where, limit))
        assert got == want, (trial, fmt, select, where, limit, data[:200])


def _rand_sql(rng):
    """SQL text from the grammar's pieces, with a share of broken input."""
    fields = ["a", "b", "num", "s", "nested.x", "arr.0", "x_1"]
    lits = ["5", "-3.25", "0", "'abc'", "'a''b'", "\"q\"", "'it\\'s'", "1.5.2", "'%'",
            "'a%b'", "'%mid%'", "'pre%'", "'_x'", "'a\\%b'", "'a\\_'", "12345678901234567"]
    ops = ["=", "!=", "<>", "<", "<=", ">", ">=", "LIKE", "like", "=="]

    def expr(depth=0):
        r = rng.random()
        if depth < 2 and r < 0.2:
            return f"({expr(depth + 1)})"
        if depth < 2 and r < 0.35:
            return f"NOT {expr(depth + 1)}"
        if depth < 2 and r < 0.55:
            return f"{expr(depth + 1)} {rng.choice(['AND', 'OR', 'and', 'or'])} {expr(depth + 1)}"
        return f"{rng.choice(fields)} {rng.choice(ops)} {rng.choice(lits)}"

    sel = "*" if rng.random() < 0.4 else ", ".join(rng.sample(fields, rng.randint(1, 3)))
    parts = [rng.choice(["SELECT", "select"]), sel, "FROM", rng.choice(["s3object", "t", "1x"])]
    if rng.random() < 0.8:
        parts += ["WHERE", expr()]
    if rng.random() < 0.4:
        parts += ["LIMIT", rng.choice(["3", "0", "-5", "2.5", "007", "x"])]
    text = " ".join(parts)
    if rng.random() < 0.15:  # a broken statement
        cut = rng.randint(0, len(text))
        text = text[:cut] + rng.choice(["", "@", " )", " AND", "'"]) + text[cut:]
    return text


@pytest.mark.parametrize("seed", [7, 8])
def test_sql_front_end_equals_the_reference(seed):
    """parse_sql results, or the exception's type and message (SqlError
    included), and run_sql on a seeded CSV."""
    rng = random.Random(seed)
    for trial in range(300):
        text = _rand_sql(rng)

        def parse(mod):
            try:
                return mod.parse_sql(text), None
            except Exception as e:  # noqa: BLE001
                return None, (type(e).__name__, str(e))

        want, got = parse(jsql), parse(psql)
        assert got == want, (trial, text)
        if want[0] is not None:
            data = GEN.rand_csv(rng)
            assert (_outcome(lambda: psql.run_sql(data, text, "csv"))
                    == _outcome(lambda: jsql.run_sql(data, text, "csv"))), (trial, text)
    assert issubclass(psql.SqlError, ValueError)


# ------------------------------------------------------- directed cases

CSV = b"id,region,score\n1,east,10\n2,west,995.5\n3,east,-4\n4,,0.25\n"


def test_kernel_rows_stay_vectorized():
    """Plain ASCII simple-numeric CSV must NOT fall back to the exact lane
    (values like ``1e3`` or quoting would)."""
    before = QUERY_COUNTERS["kernel"].value(backend="cpu")
    plan = pscan.compile_plan(None, {"field": "score", "op": ">", "value": 9}, 0, "csv", "cpu")
    rows = plan.execute(CSV)
    assert [r["id"] for r in rows] == ["1", "2"]
    assert plan.stats == {"rows_scanned": 4, "rows_kernel": 4, "rows_fallback": 0,
                          "bytes_scanned": len(CSV)}
    assert QUERY_COUNTERS["kernel"].value(backend="cpu") == before + 4


def test_quoted_rows_take_exact_lane():
    data = b'a,b\n"x,y",1\np,2\n'
    where = {"field": "b", "op": ">", "value": 0}
    plan = pscan.compile_plan(None, where, 0, "csv", "cpu")
    assert plan.execute(data) == jengine.run_query(data, "csv", where=where)
    assert plan.stats["rows_fallback"] >= 1


def test_limit_stops_consuming_chunks():
    pulled = []

    def chunks():
        for i in range(50):
            c = b"field\n" + (b"%d\n" % i) * 100
            pulled.append(len(c))
            yield c

    plan = pscan.compile_plan(None, {"field": "field", "op": ">=", "value": 0}, 5, "csv", "cpu")
    rows = [r for b in plan.scan_iter(chunks()) for r in b]
    assert len(rows) == 5
    assert len(pulled) < 50  # stopped early
    assert plan.stats["bytes_scanned"] == sum(pulled)


@pytest.mark.parametrize("name", ["numpy", "jax", "tpu", "auto", "cuda:0"])
def test_unknown_backend_rejected(name):
    with pytest.raises(ValueError, match="unknown query backend"):
        pscan.get_kernels(name)


def test_default_backend_is_cuda_with_no_fallback(monkeypatch):
    """No argument and no $SWEED_QUERY_BACKEND: cuda. Without a card, a
    plan (and a request) raises an error naming the device."""
    monkeypatch.delenv("SWEED_QUERY_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda.*no CUDA device"):
        pscan.get_kernels()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pscan.compile_plan(None, None, 0, "csv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execute_request(CSV, {"input": "csv", "sql": "SELECT * FROM s3object"})
    monkeypatch.setenv("SWEED_QUERY_BACKEND", "cpu")
    assert pscan.get_kernels().name == "cpu"
    assert execute_request(CSV, {"input": "csv", "sql": "SELECT id FROM s3object LIMIT 1"}) \
        == (200, {"rows": [{"id": "1"}], "count": 1})


@pytest.mark.parametrize("req", [
    {"sql": "SELECT FROM"},
    {"sql": "SELECT * FROM s3object LIMIT -5", "input": "csv"},
    {"sql": "SELECT id, score FROM s3object WHERE score > 1 OR region = 'west'",
     "input": "csv"},
    {"input": "csv", "limit": "-5"}, {"input": "csv", "limit": "+5"},
    {"input": "csv", "limit": " 5 "}, {"input": "csv", "limit": "x"},
    {"input": "csv", "limit": -5}, {"input": "csv", "limit": "2"},
    {"input": "csv", "where": {"field": "region", "op": "=", "value": "east"},
     "select": ["id", "nope"]},
])
def test_request_equals_the_reference(req, monkeypatch):
    """execute_request's (status, payload) against the JAX package's: the
    ``bad sql`` 400 and the tolerant ``limit`` included."""
    from seaweedfs_tpu import query as jquery

    monkeypatch.setenv("SWEED_QUERY_BACKEND", "numpy")  # the JAX side's eager backend
    assert execute_request(CSV, req, "cpu") == jquery.execute_request(CSV, req)


def _field(values):
    """uint8 [rows, width] matrix + int32 lengths of a list of byte strings."""
    w = pscan._pow2(max(len(v) for v in values))
    mat = np.zeros((len(values), w), dtype=np.uint8)
    for i, v in enumerate(values):
        mat[i, :len(v)] = np.frombuffer(v, np.uint8)
    return mat, np.array([len(v) for v in values], dtype=np.int32)


# 15-digit mantissas with 1-14 fractional digits, and the corner spellings
EDGE = (
    [b"123456789012345"[: 15 - f] + b"." + b"123456789012345"[15 - f:] for f in range(1, 15)]
    + [b"-" + b"987654321098765"[: 15 - f] + b"." + b"987654321098765"[15 - f:]
       for f in range(1, 15)]
    + [b"0.1", b"-0", b"0", b"5.", b".5", b"99999999999999.9", b"999999999999999",
       b"0.000000000000001", b"-0.0", b"1.5.", b"1.2.3", b"12", b"1e3", b"+5", b"1_0",
       b"1234567890123456", b"-", b"", b"0005", b"3.14159"]
)


def _check_numeric(device):
    k = pscan.get_kernels(device)
    mat, lens = _field(EDGE)
    vals, simple, not_float = pscan._numeric(
        torch.from_numpy(mat).to(k.device), torch.from_numpy(lens).to(k.device),
        k.ten_pows, k.floatish)
    vals, simple, not_float = vals.cpu().numpy(), simple.cpu().numpy(), not_float.cpu().numpy()
    for v, x, s, nf in zip(EDGE, vals, simple, not_float):
        text = v.decode()
        try:
            want = float(text)
        except ValueError:
            want = None
        if s:
            # the kernel domain: its value is float()'s, bit for bit
            assert want is not None and np.float64(want).view(np.int64) == \
                np.float64(x).view(np.int64), (text, x, want)
        if nf:
            assert want is None, text  # a proof that float() fails
    simple_ones = [v for v, s in zip(EDGE, simple) if s]
    assert b"99999999999999.9" in simple_ones and b"0.1" in simple_ones and b"-0" in simple_ones
    # "5." and ".5" are floats but not in the simple domain: exact lane
    for v in (b"5.", b".5", b"1e3", b"+5", b"1_0", b"1234567890123456"):
        i = EDGE.index(v)
        assert not simple[i] and not not_float[i], v


def test_numeric_edge_corpus_equals_float():
    _check_numeric("cpu")


def test_primitives_equal_the_reference_bit_for_bit():
    """The torch primitives against the JAX package's numpy ones, on random
    fields over a numeric-ish alphabet: every mask equal, and the values of
    simple rows equal to the bit (other rows' values are never read)."""
    k = pscan.get_kernels("cpu")
    rng = np.random.default_rng(0)
    alph = np.frombuffer(b"0123456789.-e+ abc\xc3", np.uint8)
    for w in (8, 16, 64):
        n = 3000
        mat = alph[rng.integers(0, len(alph), (n, w))]
        lens = rng.integers(0, w + 1, n).astype(np.int32)
        mt, lt = torch.from_numpy(mat), torch.from_numpy(lens)
        v1, s1, d1 = jscan._numeric(np, mat, lens)
        v2, s2, d2 = pscan._numeric(mt, lt, k.ten_pows, k.floatish)
        assert np.array_equal(s1, s2.numpy()) and np.array_equal(d1, d2.numpy()), w
        assert np.array_equal(v1[s1].view(np.int64), v2.numpy()[s1].view(np.int64)), w
        assert np.array_equal(jscan._ascii_ok(np, mat, lens), pscan._ascii_ok(mt, lt).numpy())
        for nb in (b"", b"1", b"12", b"0.5", b"-3", b"a" * 70):
            nd = k.needle(nb)
            assert np.array_equal(jscan._eq_bytes(np, mat, lens, nb),
                                  pscan._eq_bytes(mt, lt, nd).numpy()), nb
            assert np.array_equal(jscan._prefix(np, mat, lens, nb),
                                  pscan._prefix(mt, lt, nd).numpy()), nb
            lt_want, eq_want = jscan._lex_lt_eq(np, mat, lens, nb)
            lt_got, eq_got = pscan._lex_lt_eq(mt, lt, nd)
            assert np.array_equal(lt_want, lt_got.numpy()), nb
            assert np.array_equal(eq_want, eq_got.numpy()), nb
            if nb:
                assert np.array_equal(jscan._substr(np, mat, lens, nb),
                                      pscan._substr(mt, lt, nb).numpy()), nb


def _check_first_index(device):
    """argmax must pick the FIRST dot and the FIRST mismatch."""
    k = pscan.get_kernels(device)
    mat, lens = _field([b"1.2.5", b"12.3.4", b"9.9"])
    mt, lt = torch.from_numpy(mat).to(k.device), torch.from_numpy(lens).to(k.device)
    vals = pscan._numeric(mt, lt, k.ten_pows, k.floatish)[0].cpu().numpy()
    want = jscan._numeric(np, mat, lens)[0]
    # two dots: frac counts from the first one (1.25 / 10 and 1234 / 1000)
    assert vals.tolist() == want.tolist() == [12.5 / 100.0, 1234.0 / 1000.0, 9.9]
    # "axc" vs "abd": mismatches at 1 and 2; the first decides (x > b)
    mat, lens = _field([b"axc", b"aac", b"abd", b"abc"])
    mt, lt = torch.from_numpy(mat).to(k.device), torch.from_numpy(lens).to(k.device)
    lt_got, eq_got = pscan._lex_lt_eq(mt, lt, k.needle(b"abd"))
    assert lt_got.cpu().tolist() == [False, True, False, True]
    assert eq_got.cpu().tolist() == [False, False, True, False]


def test_argmax_takes_the_first_index():
    _check_first_index("cpu")


def test_scans_are_counted_by_backend():
    before = QUERY_COUNTERS["scans"].value(backend="cpu")
    rows_before = QUERY_COUNTERS["kernel"].total()
    pscan.run_scan(CSV, "csv", where={"field": "id", "op": "=", "value": 1}, backend="cpu")
    assert QUERY_COUNTERS["scans"].value(backend="cpu") == before + 1
    assert QUERY_COUNTERS["kernel"].total() == rows_before + 4


def test_counter_survives_request_threads():
    """The counters are bumped from server request threads: no lost
    update under a short switch interval."""
    c = Counter("t")
    per, threads = 2000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=lambda: [c.inc(backend="cuda") for _ in range(per)])
                for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert c.value(backend="cuda") == c.total() == per * threads


@pytest.mark.cuda
def test_cuda_backend_equals_cpu_backend_on_the_card():
    """The cuda plans against the cpu plans on the differential corpus, the
    numeric edge corpus against float() on the card, and argmax's first
    index (runs only where there is a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = QUERY_COUNTERS["kernel"].value(backend="cuda")
    for trial, case in enumerate(_corpus(99, 300)):
        want = _outcome(lambda: _scan("cpu", *case))
        got = _outcome(lambda: _scan("cuda", *case))
        assert got == want, (trial, case[:5])
    assert QUERY_COUNTERS["kernel"].value(backend="cuda") > before
    _check_numeric("cuda")
    _check_first_index("cuda")


# ------------------------------------------- where the structural index runs

def _index_segments(where):
    return QUERY_COUNTERS["index_segments"].value(where=where)


def test_cpu_plans_index_on_the_host():
    """The ``cpu`` backend keeps the numpy index: every segment it scans
    counts ``where="host"``, none ``"card"``."""
    host, card = _index_segments("host"), _index_segments("card")
    plan = pscan.compile_plan(None, {"field": "score", "op": ">", "value": 9}, 0, "csv", "cpu")
    assert [r["id"] for r in plan.execute(CSV)] == ["1", "2"]
    pieces = [CSV[:20], CSV[20:41], CSV[41:]]
    assert [r for b in plan.scan_iter(iter(pieces)) for r in b] == plan.execute(CSV)
    assert _index_segments("card") == card
    assert _index_segments("host") > host + 2


@pytest.mark.parametrize("where", [None, {"and": []}, {"field": "score", "op": ">", "value": 9}])
def test_the_card_indexes_only_plans_with_a_tree_on_cuda(where):
    """The routing reads what the plan holds: a CSV plan with a tree on a
    CUDA device takes the card index (bodies the kernel's int32 offsets
    reach, fields its parameter block holds); a plan without a tree (no
    WHERE, or one that names no field), a ``cpu`` plan, and a body past
    int32 take the host's."""
    plan = pscan.compile_plan(None, where, 0, "csv", "cpu")
    assert not plan._indexes_on_card(len(CSV))
    plan.kernels.device = torch.device("cuda")  # what a cuda plan holds; nothing runs
    tree = where is not None and bool(where.get("field"))
    assert plan._indexes_on_card(len(CSV)) == tree
    assert plan._indexes_on_card(pscan.csv_index.MAX_BYTES) == tree
    assert not plan._indexes_on_card(pscan.csv_index.MAX_BYTES + 1)
    many = {"and": [{"field": f"f{i}", "op": "=", "value": 1}
                    for i in range(pscan.csv_index.MAX_FIELDS + 1)]}
    wide = pscan.compile_plan(None, many, 0, "csv", "cpu")
    wide.kernels.device = torch.device("cuda")
    assert not wide._indexes_on_card(len(CSV))


def test_a_cuda_plan_without_a_card_still_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pscan.compile_plan(None, {"field": "score", "op": ">", "value": 9}, 0, "csv", "cuda")


def _numpy_card_index(plan, data):
    """``csv_index.index`` as the numpy index computes it, on CPU tensors:
    what the kernel must return (widths as the tree's buckets, which
    ``_csv_segment`` buckets again to the same values)."""
    nl = data.find(b"\n")
    header = next(iter(csv.reader([data[:nl].decode("utf-8", errors="replace")])), [])

    def index(staged, n, cols, row_batch):
        assert list(cols) == plan._columns(header)
        starts, ends, commas, ci0, ci1 = plan._host_index(staged[:n].numpy(), header)
        exact = np.zeros(len(starts), dtype=bool)
        parts, widths = [], []
        for lo in range(0, len(starts), row_batch):
            hi = min(lo + row_batch, len(starts))
            v, w = plan._field_vectors(starts[lo:hi], ends[lo:hi], commas, ci0[lo:hi],
                                       ci1[lo:hi], header, exact[lo:hi])
            parts.append(v)
            widths.append(w)
        vecs = (np.concatenate(parts, axis=2) if parts
                else np.zeros((len(cols), 3, 0), dtype=np.int32))
        rows = np.stack([starts, ends, exact.astype(starts.dtype)]).astype(np.int32)
        return pscan.csv_index.CardIndex(
            len(starts), int(exact.sum()), np.array(widths).reshape(-1, len(cols)),
            torch.from_numpy(vecs.astype(np.int32)), torch.from_numpy(rows), None)

    return index


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_card_batches_equal_the_reference_engine(seed, monkeypatch):
    """The card path's glue (the batches over the card's index, their
    widths, the exact rows, rows decoded from the body's view) on the CPU,
    with the kernel's results computed by the numpy index: byte-identical
    to ``engine.run_query`` whatever the chunk split, small batches
    included, and every such segment counted ``where="card"``."""
    monkeypatch.setattr(pscan, "_ROW_BATCH", 4)
    monkeypatch.setattr(pscan.ScanPlan, "_indexes_on_card",
                        lambda self, n: self._tree is not None)
    card = _index_segments("card")
    for trial, (fmt, data, select, where, limit, pieces) in enumerate(_corpus(seed, 150)):
        if fmt != "csv":
            continue
        plan = pscan.compile_plan(select, where, limit, fmt, "cpu")
        numpy_index = _numpy_card_index(plan, data)
        plan._card_index = lambda staged, n, header: numpy_index(
            staged, n, plan._columns(header), pscan._ROW_BATCH)
        want = _outcome(lambda: jengine.run_query(data, input_format=fmt, select=select,
                                                  where=where, limit=limit))
        got = _outcome(lambda: [r for b in plan.scan_iter(iter(pieces or (data,))) for r in b])
        assert got == want, (trial, select, where, limit, data[:200])
    assert _index_segments("card") > card


# ------------------------------------------------ the kernel against numpy

def _blank_and_ragged():
    """Blank lines (several in a row), short and long rows, duplicate
    header names, a field of exactly 512 bytes and one of 513, a row
    longer than the kernel's tile, a field name the header lacks."""
    lines = [b"a,b,a,c,d"]
    rng = random.Random(3)
    for i in range(3000):
        k = rng.random()
        if k < 0.05:
            lines.append(b"")
        elif k < 0.07:
            lines.extend([b"", b"", b""])
        else:
            ncol = rng.randint(0, 8)
            lines.append(b",".join(str(rng.randint(-99, 99999)).encode() * rng.randint(1, 3)
                                   for _ in range(ncol)))
    lines[100] = b"1," + b"x" * 512 + b",2,3"
    lines[200] = b"1,2," + b"y" * 513 + b",4"
    lines[300] = b",".join([b"7"] * 3000) + b"," + b"z" * 6000  # > 4096 bytes
    lines[301] = b"9," + b"w" * 9000  # a field across several tiles
    return b"\n".join(lines)


CARD_FIELDS = ["a", "b", "c", "d", "missing", "x.y"]


def _card_segments():
    body = _blank_and_ragged()
    yield "ragged", body + b"\n", CARD_FIELDS, 2048
    yield "no final newline", body, CARD_FIELDS, 2048
    yield "blank tail", body + b"\n\n\n\n", CARD_FIELDS, 2048
    yield "one row", b"1,2,3,4,5", CARD_FIELDS, pscan._ROW_BATCH
    yield "only blank lines", b"\n\n\n", CARD_FIELDS, pscan._ROW_BATCH
    item = lineitem_csv(2**31 + 23, 0, 32 << 20)
    nl = item.find(b"\n")
    yield "lineitem 32 MiB", item[nl + 1:], ["l_shipdate", "l_discount", "l_quantity"], \
        pscan._ROW_BATCH


@pytest.mark.cuda
def test_card_index_equals_the_numpy_index_on_the_card():
    """csv_index.cu's rows, field vectors (start where present), exact rows
    and per-batch widths against the numpy index, on the corpus of
    ``_card_segments`` (runs only where there is a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    header_of = {"lineitem 32 MiB": list(COLUMNS)}
    launches = pscan.csv_index.index.launches
    for name, body, fields, row_batch in _card_segments():
        header = header_of.get(name, ["a", "b", "a", "c", "d"])
        where = {"and": [{"field": f, "op": "=", "value": 1} for f in fields]}
        plan = pscan.compile_plan(None, where, 0, "csv", "cpu")
        arr = np.frombuffer(body, np.uint8)
        pad = np.zeros(len(arr) + pscan._MAX_FIELD_W + 8, dtype=np.uint8)
        pad[:len(arr)] = arr
        got = pscan.csv_index.index(torch.from_numpy(pad).cuda(), len(arr),
                                    plan._columns(header), row_batch)
        starts, ends, commas, ci0, ci1 = plan._host_index(arr, header)
        assert got.nrows == len(starts), name
        g_starts, g_ends, g_exact = got.rows(0, got.nrows)
        assert np.array_equal(g_starts, starts) and np.array_equal(g_ends, ends), name
        exact = np.zeros(len(starts), dtype=bool)
        vecs = got.vecs.cpu().numpy()
        for b, lo in enumerate(range(0, len(starts), row_batch)):
            hi = min(lo + row_batch, len(starts))
            want, buckets = plan._field_vectors(starts[lo:hi], ends[lo:hi], commas, ci0[lo:hi],
                                                ci1[lo:hi], header, exact[lo:hi])
            v = vecs[:, :, lo:hi]
            present = want[:, 2] != 0
            assert np.array_equal(v[:, 1:], want[:, 1:]), (name, b)
            assert np.array_equal(np.where(present, v[:, 0], 0),
                                  np.where(present, want[:, 0], 0)), (name, b)
            assert got.widths[b].tolist() == want[:, 1].max(axis=1).tolist(), (name, b)
            assert tuple(pscan._pow2(min(int(w), pscan._MAX_FIELD_W) or 1)
                         for w in got.widths[b]) == buckets, (name, b)
        assert np.array_equal(g_exact, exact) and got.nexact == int(exact.sum()), name
        assert got.widths.shape == (-(-len(starts) // row_batch), len(fields)), name
    assert pscan.csv_index.index.launches > launches


@pytest.mark.cuda
@pytest.mark.parametrize("data", [b"", b"a,b,c\n", b"a,b,c", b"a,b,c\n\n\n",
                                  b"a,b,c\n1,2,3", b"a,b,c\n" + b"1,2,3\n" * 5000])
def test_empty_and_header_only_objects_on_the_card(data):
    """An empty object, a header-only one, blank bodies and a body without
    a final newline: the cuda plan's rows equal the cpu plan's, and every
    segment with a body counts ``where="card"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    where = {"field": "b", "op": ">=", "value": 2}
    card = _index_segments("card")
    got = pscan.run_scan(data, "csv", where=where, backend="cuda")
    assert got == pscan.run_scan(data, "csv", where=where, backend="cpu")
    body = data[data.find(b"\n") + 1:] if b"\n" in data else b""
    assert _index_segments("card") == card + bool(body)
