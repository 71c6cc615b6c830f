"""The span readers (``swbench/spans.py`` and the per-layer metrics that use
it): each on a synthetic span list, ``idle_spans`` on synthetic device
events, and the twelve metrics read from the program's own spans in a
traced run of each cell on the CPU."""

import pytest

from conftest import run_small
from swbench import harness, spans

MS = 1_000_000


def sp(name, start, end, sid, parent="", thread=1, **tags):
    return {"name": name, "start_ns": start, "end_ns": end, "span_id": sid,
            "parent_id": parent, "thread": thread, "tags": tags}


def _reader(metric):
    return harness.Spec().reader("layers", metric).read


def _query(q, t0, parent_tags=None, index_ms=10, late=False):
    """One /_query server span at ``t0`` ms with its layer spans: the
    needle read 3 ms, the index ``index_ms`` (a child of 1 ms inside it),
    the device 2 ms, the rows 1 ms, the reply 1 ms."""
    at = t0 * MS
    out = [sp("daemon.needle_read", at + MS, at + 4 * MS, f"{q}n", q, bytes=5),
           sp("query.index", at + 4 * MS, at + (4 + index_ms) * MS, f"{q}i", q, rows=7),
           sp("inner", at + 5 * MS, at + 6 * MS, f"{q}x", f"{q}i"),
           sp("query.device", at + (4 + index_ms) * MS, at + (6 + index_ms) * MS, f"{q}d", q),
           sp("query.rows", at + (6 + index_ms) * MS, at + (7 + index_ms) * MS, f"{q}r", q),
           sp("daemon.reply", at + (7 + index_ms) * MS, at + (8 + index_ms) * MS, f"{q}p", q)]
    end = at + (9 + index_ms) * MS + (100 * MS if late else 0)
    tags = {"status": 200, **(parent_tags or {})}
    return out + [sp(spans.QUERY, at, end, q, **tags)]


def test_query_readers_on_a_synthetic_window():
    listed = (_query("w", 0, index_ms=50)  # the warm-up: before the window
              + _query("a", 100, {"engine_ns": 99 * MS})
              + _query("b", 200, {"engine_ns": 197 * MS})
              + _query("c", 300, late=True))  # answered after the window
    run = {"spans": listed, "work": {"requests": 3, "answered_after_window": 1}}
    got = {m: _reader(m)(run) for m in (
        "engine.proxy_wait_ms.read", "daemon.needle_read_ms.read", "query.index_ms.read",
        "query.device_ms.read", "query.rows_ms.read", "daemon.reply_ms.read")}
    assert got == pytest.approx({
        "engine.proxy_wait_ms.read": 2.0, "daemon.needle_read_ms.read": 3.0,
        "query.index_ms.read": 9.0,  # 10 ms less its 1 ms child
        "query.device_ms.read": 2.0, "query.rows_ms.read": 1.0, "daemon.reply_ms.read": 1.0})
    # the same window given by its bounds
    by_bounds = {"spans": listed, "window_ns": (50 * MS, 250 * MS)}
    assert _reader("query.index_ms.read")(by_bounds) == pytest.approx(9.0)
    # a failed query is not in the base
    listed[-8]["tags"]["status"] = 500
    assert _reader("query.device_ms.read")(run) == pytest.approx(2.0)


def _cycle(c, t0, thread_base=10):
    """A generate (legs on three threads, sums, commit) and a rebuild (legs)
    at ``t0`` ms."""
    at, g, r = t0 * MS, f"{c}g", f"{c}r"
    out = []
    for k, leg in enumerate(("ec.read", "ec.h2d", "ec.d2h", "ec.write")):
        for chunk in range(2):
            s = at + (k + chunk * 4) * MS
            out.append(sp(leg, s, s + MS, f"{g}{leg}{chunk}", g, thread=thread_base + k))
            s = at + (100 + k + chunk * 4) * MS
            out.append(sp(leg, s, s + 2 * MS, f"{r}{leg}{chunk}", r, thread=thread_base + k))
    out += [sp("store.sums", at + 20 * MS, at + 50 * MS, f"{g}s", g),
            sp("store.commit", at + 50 * MS, at + 90 * MS, f"{g}c", g, files=16),
            sp(spans.GENERATE, at, at + 95 * MS, g),
            sp(spans.REBUILD, at + 100 * MS, at + 120 * MS, r)]
    return out


def test_seal_readers_on_a_synthetic_window():
    listed = _cycle("warm", 0) + _cycle("one", 1000) + _cycle("two", 2000)
    run = {"spans": listed, "work": {"generates": 2, "rebuilds": 2}}
    got = {m: _reader(m)(run) for m in (
        "ec_pipeline.read_s.seal", "ec_pipeline.h2d_s.seal", "ec_pipeline.d2h_s.seal",
        "ec_pipeline.write_s.seal", "store.sums_s.seal", "store.commit_s.seal")}
    # per cycle: each leg 2 x 1 ms in the generate and 2 x 2 ms in the rebuild
    legs = 0.006
    assert got == pytest.approx({
        "ec_pipeline.read_s.seal": legs, "ec_pipeline.h2d_s.seal": legs,
        "ec_pipeline.d2h_s.seal": legs, "ec_pipeline.write_s.seal": legs,
        "store.sums_s.seal": 0.030, "store.commit_s.seal": 0.040})
    assert _reader("store.sums_s.seal")({"spans": listed, "work": {}}) is None


def test_a_ring_keeps_only_whole_trees():
    """Spans of the query that started before the oldest held span ended
    may be gone: that query is left out."""
    listed = _query("a", 100) + _query("b", 200)
    cut = listed[3:]  # a's needle read, index and its child are gone
    horizon = cut[0]["end_ns"]
    base = spans.held(spans.window_servers({}, cut, spans.QUERY, 2), horizon)
    assert [q["span_id"] for q in base] == ["b"]


def test_readers_read_nothing_from_a_program_without_span_stamps(monkeypatch):
    """The parent's spans carry ``start`` and ``duration_ms`` only."""
    from seaweedfs_tpu_torch.stats import trace

    old = [{k: v for k, v in s.items() if k not in ("start_ns", "end_ns", "thread")}
           for s in _query("a", 0)]
    monkeypatch.setattr(trace.RING, "snapshot", lambda limit=256: old)
    run = {"work": {"requests": 1, "generates": 1, "rebuilds": 1}}
    for m in ("engine.proxy_wait_ms.read", "query.index_ms.read", "store.commit_s.seal"):
        assert _reader(m)(run) is None


def test_self_time_is_less_the_union_of_children():
    parent = sp("p", 0, 100, "p")
    kids = [sp("a", 10, 40, "a", "p"), sp("b", 30, 60, "b", "p", thread=2),
            sp("c", 90, 130, "c", "p")]
    assert spans.self_ns(parent, kids) == 100 - 50 - 10


def test_idle_spans_on_synthetic_device_events():
    # the card is busy [10, 20) and [60, 70) of the window [0, 100)
    events = [("k", 10, 20), ("Memcpy HtoD", 60, 70), ("k", 150, 160)]
    listed = [sp("outer", 0, 50, "o", thread=1), sp("inner", 30, 40, "i", "o", thread=1),
              sp("other", 35, 55, "x", thread=2), sp("late", 80, 200, "l", thread=3)]
    got = dict(spans.idle_spans(events, listed, 0, 100))
    # [0,10) outer; [20,30) outer; [30,35) inner; [35,40) inner+other split;
    # [40,50) outer+other split; [50,55) other; [55,60) none; [70,80) none;
    # [80,100) late
    assert got == pytest.approx({"outer": (10 + 10 + 5) / 1e9, "inner": (5 + 2.5) / 1e9,
                                 "other": (2.5 + 5 + 5) / 1e9, "late": 20 / 1e9,
                                 spans.NO_SPAN: 15 / 1e9})
    assert sum(got.values()) == pytest.approx(80 / 1e9)  # the idle time
    assert spans.idle_spans(events, listed, 0, 100, top=1)[0][0] == "outer"
    assert spans.idle_spans(events, listed, 0, 100, top=1)[-1][0] == spans.NO_SPAN


NEW = {"lineitem-q6-select": ["engine.proxy_wait_ms.read", "daemon.needle_read_ms.read",
                              "query.index_ms.read", "query.device_ms.read",
                              "query.rows_ms.read", "daemon.reply_ms.read"],
       "ec-seal-rebuild": ["ec_pipeline.read_s.seal", "ec_pipeline.h2d_s.seal",
                           "ec_pipeline.d2h_s.seal", "ec_pipeline.write_s.seal",
                           "store.sums_s.seal", "store.commit_s.seal"]}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reads_the_programs_spans(small_root, cell):
    line = run_small(small_root, cell, trace=True)
    assert line["correct"], line
    got = {m: line["metrics"][m]["value"] for m in NEW[cell]}
    assert all(v > 0 for v in got.values()), got
    plain = run_small(small_root, cell)  # no per-layer metric in an untraced run
    assert not set(NEW[cell]) & set(plain["metrics"])
