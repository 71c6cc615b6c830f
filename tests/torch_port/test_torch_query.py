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
