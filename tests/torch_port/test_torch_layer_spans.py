"""The port's layer spans (``stats/trace.py``): their clock, the recorder,
the kill switch, and the spans of the query and seal paths.

A span stamps ``start_ns`` from ``time.time_ns()`` and ``end_ns`` from a
``perf_counter_ns`` delta, and records its thread. A ``Recorder`` gets every
span finished while it is open. On the ``cpu`` backend, a ``/_query``
proxied by the native engine makes ``daemon.needle_read``, ``query.index``,
``query.device``, ``query.rows`` and ``daemon.reply`` under its server
span, which carries the engine's stamp. On the CPU codec, the encoder's
four leg spans are parented on the caller's span across the leg threads,
and ``pipeline_stats``' busy times are the sums of the leg spans; a seal
makes ``store.sums`` and ``store.commit``.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.ec import encoder
from seaweedfs_tpu_torch.ec.codec import get_codec
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.query import scan
from seaweedfs_tpu_torch.server.http_util import http_bytes_headers, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

LEGS = {"read": "ec.read", "compute": "ec.h2d", "fetch": "ec.d2h", "write": "ec.write"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _descendants(spans: list, root_id: str) -> list:
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)
    out, todo = [], [root_id]
    while todo:
        for s in kids.get(todo.pop(), []):
            out.append(s)
            todo.append(s["span_id"])
    return out


# -- the clock, the recorder, the kill switch -------------------------------------
def test_span_stamps_fall_between_clock_readings():
    before = time.time_ns()
    with trace.start_span("outer", service="t") as outer:
        time.sleep(0.02)
        with trace.start_span("inner", service="t") as inner:
            pass
    after = time.time_ns()
    assert before <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= after
    assert outer.end_ns - outer.start_ns >= 20_000_000
    assert outer.thread == inner.thread == threading.get_native_id()
    d = outer.to_dict()
    assert d["start"] == outer.start_ns / 1e9
    assert d["duration_ms"] == round((outer.end_ns - outer.start_ns) / 1e6, 3)
    assert (d["start_ns"], d["end_ns"], d["thread"]) == (outer.start_ns, outer.end_ns,
                                                         outer.thread)


def test_an_open_recorder_gets_every_finished_span_and_none_once_closed():
    names = [f"s{i}" for i in range(3000)]  # more than the ring holds
    rec = trace.Recorder().open()
    try:
        def work(part):
            for n in part:
                with trace.start_span(n, service="t"):
                    pass

        threads = [threading.Thread(target=work, args=(names[i::4],)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        rec.close()
    with trace.start_span("after", service="t"):
        pass
    assert sorted(s.name for s in rec.spans) == sorted(names)
    assert len({s.thread for s in rec.spans}) == 4
    assert trace.RING.snapshot(1)[0]["name"] == "after"  # the ring got it
    with trace.Recorder() as again:
        with trace.start_span("inside", service="t"):
            pass
    assert [d["name"] for d in again.dicts()] == ["inside"]


def test_kill_switch_records_nothing(monkeypatch):
    monkeypatch.setenv("SWEED_TRACE", "0")
    trace.RING.clear()
    with trace.Recorder() as rec:
        scope = trace.start_span("off", service="t")
        with scope as span:
            time.sleep(0.005)
        assert span is None and scope.seconds >= 0.005  # still timed for its caller
    assert rec.spans == [] and trace.RING.snapshot() == []


# -- the query path ---------------------------------------------------------------------
def _csv(rows: int) -> bytes:
    rng = np.random.default_rng(rows)
    lines = [b"id,region,score"] + [
        b"%d,%s,%d" % (i, rng.choice([b"east", b"west"]), rng.integers(0, 1000))
        for i in range(rows)]
    return b"\n".join(lines) + b"\n"


def test_query_spans_nest_under_the_server_span(tmp_path, monkeypatch):
    monkeypatch.delenv("SWEED_TURBO", raising=False)  # the engine proxies /_query
    monkeypatch.setattr(scan, "_ROW_BATCH", 512)  # several batches a segment
    rows = 2000
    data = _csv(rows)
    master = MasterServer(port=free_port(), node_timeout=60).start()
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.5, ec_backend="cpu").start()
    try:
        assert vs.turbo is not None, vs.turbo_status()
        url = f"127.0.0.1:{vs.port}"
        http_json("POST", f"http://{url}/admin/assign_volume?volume=3&replication=000")
        assert http_bytes_headers("POST", f"http://{url}/3,0100000077", data)[0] == 201
        sql = "SELECT id, score FROM s3object WHERE score > 500"
        st, body, hdrs = http_bytes_headers("POST", f"http://{url}/_query", json.dumps(
            {"fid": "3,0100000077", "input": "csv", "sql": sql}).encode())
        assert st == 200
        tid = {k.lower(): v for k, v in hdrs.items()}["x-sweed-trace-id"]
        got = json.loads(body)["rows"]
        end = time.monotonic() + 5
        while time.monotonic() < end:
            spans = trace.RING.for_trace(tid)
            if any(s["name"] == "POST /_query" for s in spans):
                break
            time.sleep(0.02)
    finally:
        vs.stop()
        master.stop()
    (server,) = [s for s in spans if s["name"] == "POST /_query"]
    assert server["tags"]["status"] == 200
    assert 0 < server["tags"]["engine_ns"] <= server["start_ns"]
    under = _descendants(spans, server["span_id"])
    names = {s["name"] for s in under}
    assert names == {"daemon.needle_read", "query.index", "query.device", "query.rows",
                     "daemon.reply"}, names
    assert all(server["start_ns"] <= s["start_ns"] <= s["end_ns"] <= server["end_ns"]
               for s in under)
    by = {n: [s for s in under if s["name"] == n] for n in names}
    assert sum(s["tags"].get("rows", 0) for s in by["query.index"]) == rows
    assert sum(s["tags"].get("batch_rows", 0) for s in by["query.index"]) == rows
    assert len(by["query.rows"]) == -(-rows // 512)
    assert sum(s["tags"]["rows_in"] for s in by["query.rows"]) == rows
    assert sum(s["tags"]["rows_out"] for s in by["query.rows"]) == len(got) > 0
    assert by["daemon.needle_read"][0]["tags"]["bytes"] == len(data)
    assert by["daemon.reply"][0]["tags"]["bytes"] == len(body)
    assert all(s["tags"]["bytes"] > 0 for s in by["query.device"])


# -- the seal path ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def codec():
    return get_codec(device="cpu")


@pytest.mark.parametrize("step", ["generate", "rebuild"])
def test_encoder_leg_spans_are_the_pipeline_stats(tmp_path, codec, step):
    base = str(tmp_path / "v")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(7).bytes(200_000))
    stats: dict = {}
    kw = dict(chunk_bytes=4096, pipeline_stats=stats)
    if step == "rebuild":
        encoder.write_ec_files(base, codec, large_block_size=8192, small_block_size=1024)
        for sid in (0, 3, 10, 13):
            os.remove(base + shard_ext(sid))
    with trace.Recorder() as rec, trace.start_span("caller", service="t") as caller:
        if step == "generate":
            encoder.write_ec_files(base, codec, large_block_size=8192, small_block_size=1024,
                                   **kw)
        else:
            assert encoder.rebuild_ec_files(base, codec, **kw) == [0, 3, 10, 13]
    legs = [s for s in rec.spans if s.name.startswith("ec.")]
    assert {s.name for s in legs} == set(LEGS.values())
    assert all((s.trace_id, s.parent_id) == (caller.trace_id, caller.span_id) for s in legs)
    # the reader, writer and fetch legs each on a thread of its own
    threads = {n: {s.thread for s in legs if s.name == n} for n in LEGS.values()}
    assert threads["ec.h2d"] == {caller.thread}
    assert len(set().union(*threads.values())) == 4
    for stage, name in LEGS.items():
        ns = sum(s.end_ns - s.start_ns for s in legs if s.name == name)
        assert stats[f"{stage}_busy_s"] == pytest.approx(ns / 1e9, abs=1e-9 * len(legs))
    moved = {n: sum(s.tags["bytes"] for s in legs if s.name == n) for n in LEGS.values()}
    width = os.path.getsize(base + shard_ext(1))
    rows = 14 if step == "generate" else 4
    assert moved["ec.write"] == rows * width  # what the shard files hold
    assert moved["ec.read"] >= moved["ec.h2d"] > 0 and moved["ec.d2h"] > 0


def test_a_seal_makes_its_sums_and_commit_spans(tmp_path):
    s = Store([str(tmp_path / "d")], ec_backend="cpu")
    try:
        s.add_volume(5)
        for nid in range(1, 40):
            s.write_volume_needle(5, Needle(cookie=9, id=nid, data=os.urandom(5000)))
        with trace.Recorder() as rec, trace.start_span("seal", service="t") as root:
            assert s.ec_encode_volume(5) == list(range(14))
        base = s.find_volume(5).file_name()
    finally:
        s.close()
    under = {sp.name: sp for sp in rec.spans if sp.parent_id == root.span_id}
    assert {"store.sums", "store.commit", "ec.h2d"} <= set(under)
    sums = under["store.sums"]
    assert sums.tags["bytes"] == sum(os.path.getsize(base + shard_ext(i)) for i in range(14))
    assert under["store.commit"].tags["files"] == 16  # 14 shards, .ecx, .vif
    assert sums.end_ns <= under["store.commit"].start_ns
