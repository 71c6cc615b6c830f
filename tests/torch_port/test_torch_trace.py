"""Tracing: the port's ``stats/trace.py`` and its wiring, against the JAX
package's.

The cases of the reference's ``tests/test_trace.py``: the span plumbing on
both packages' modules (parse and inject, parentage, the ring's bound, the
kill switch, the tree's assembly), the context crossing the port's pools,
the same span tree from both serving cores of both packages, and the end to
end trees on a port cluster: a filer PUT and GET whose trace holds filer,
master and volume spans, in both serving cores, and an S3 request that
crosses from the port's gateway (and from the JAX package's) into the port's
filer and on to a volume server. The trees are collected as an operator
would, from the daemons' ``/debug/traces`` and ``/_debug/traces``. The
histogram's exemplars are not ported, and neither is the shell's ``trace``.
"""

from __future__ import annotations

import asyncio
import os
import threading
import time

import pytest

import seaweedfs_tpu.server.http_util as j_http
import seaweedfs_tpu.stats.trace as j_trace
import seaweedfs_tpu_torch.server.http_util as p_http
import seaweedfs_tpu_torch.stats.trace as p_trace
from seaweedfs_tpu.s3api import S3ApiServer as JS3ApiServer
from seaweedfs_tpu_torch.s3api import S3ApiServer as PS3ApiServer
from seaweedfs_tpu_torch.s3api.s3_client import S3Client
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes_headers, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

from s3_pair import KINDS, free_port, stop_jax_server

TRACE = {"jax": j_trace, "port": p_trace}
HTTP = {"jax": j_http, "port": p_http}


@pytest.fixture(autouse=True)
def _clean_rings():
    for t in TRACE.values():
        t.RING.clear()
    yield
    for t in TRACE.values():
        t.RING.clear()


@pytest.fixture(params=KINDS)
def trace(request):
    return TRACE[request.param]


# -- span basics ----------------------------------------------------------------
def test_parse_header_roundtrip(trace):
    with trace.start_span("op", service="t") as s:
        hdr = trace.inject_header()
        assert hdr == f"{s.trace_id}:{s.span_id}"
        assert trace.parse_header(hdr) == (s.trace_id, s.span_id)


@pytest.mark.parametrize("garbage", [
    None, "", "justtrace", ":", "abc:", ":def", "has space:abcd1234",
    "tid:pid:extra\r\nInjected: yes", "ффф:1234",
])
def test_parse_header_rejects_garbage(trace, garbage):
    assert trace.parse_header(garbage) == ("", "")


def test_span_parentage_and_explicit_header(trace):
    with trace.start_span("outer", service="a") as outer:
        with trace.start_span("inner", service="b") as inner:
            assert inner.trace_id == outer.trace_id and inner.parent_id == outer.span_id
        assert trace.current_span() is outer  # the window is restored
        with trace.start_span("child", service="b",
                              parent_header="feedfacefeedface:cafe0001") as s:
            assert (s.trace_id, s.parent_id) == ("feedfacefeedface", "cafe0001")
    assert trace.current_span() is None


def test_error_span_records_status_and_tag(trace):
    with pytest.raises(ValueError):
        with trace.start_span("boom", service="t"):
            raise ValueError("nope")
    last = trace.RING.snapshot()[-1]
    assert last["status"] == "error" and last["tags"]["error"] == "ValueError"


def test_ring_is_bounded(trace):
    ring = trace.TraceRing(capacity=4)
    for i in range(10):
        ring.add(trace.Span(f"s{i}", service="t"))
    st = ring.stats()
    assert st["size"] == 4 and st["added"] == 10 and st["dropped"] == 6
    assert [s["name"] for s in ring.snapshot()] == ["s6", "s7", "s8", "s9"]


def test_kill_switch_disables_everything(trace, monkeypatch):
    monkeypatch.setenv("SWEED_TRACE", "0")
    with trace.start_span("op", service="t") as s:
        assert s is None and trace.inject_header() is None
        assert trace.current_trace_id() == ""
    assert trace.RING.snapshot() == []


def test_assemble_and_format_tree_alike():
    """A tree assembled (deduped) and formatted by either package reads
    the same from the same spans."""
    with p_trace.start_span("root", service="m") as root:
        with p_trace.start_span("child", service="v"):
            pass
    spans = p_trace.RING.for_trace(root.trace_id)
    trees = {k: TRACE[k].assemble_tree(spans + [dict(spans[0])]) for k in KINDS}
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]) == 1
    assert [c["name"] for c in trees["port"][0]["children"]] == ["child"]
    lines = p_trace.format_tree(trees["port"]).splitlines()
    assert lines == j_trace.format_tree(trees["jax"]).splitlines()
    assert lines[0].startswith("m root ") and lines[1].startswith("  v child ")


# -- the context across the port's thread seams ----------------------------------
def test_bounded_executor_and_prefetch_propagate_span():
    from seaweedfs_tpu_torch.util.pipeline import BoundedExecutor, prefetch_iter

    seen = []
    with p_trace.start_span("producer", service="t") as s:
        ex = BoundedExecutor(window=2, name="t")
        for _ in range(4):
            ex.submit(lambda: seen.append(p_trace.current_trace_id()))
        ex.drain()
        pairs = list(prefetch_iter(range(4), lambda i: (i, p_trace.current_trace_id()),
                                   window=3))
    assert seen == [s.trace_id] * 4
    assert [tid for _, (_, tid) in pairs] == [s.trace_id] * 4


def test_thread_flume_bridges_bytes_not_context():
    from seaweedfs_tpu_torch.util.aio_pipeline import ThreadFlume

    results: dict = {}

    def produce(flume):
        with p_trace.start_span("producer", service="t") as s:
            results["tid"] = s.trace_id
            for _ in range(8):  # window 2: blocks on backpressure
                flume.put(b"x" * 10, timeout=5)
            results["tid_after"] = p_trace.current_trace_id()
        flume.close()

    async def main():
        flume = ThreadFlume(asyncio.get_running_loop(), window=2)
        t = threading.Thread(target=produce, args=(flume,), daemon=True)
        t.start()
        chunks = [c async for c in flume]
        results["loop_tid"] = p_trace.current_trace_id()
        t.join(5)
        return b"".join(chunks)

    assert asyncio.run(main()) == b"x" * 80
    assert results["tid_after"] == results["tid"]  # survives backpressure
    assert results["loop_tid"] == ""  # nothing leaks to the loop side


# -- the same tree from both serving cores of both packages ------------------------
def _span_tree_shape(kind, mode, monkeypatch):
    http, trace = HTTP[kind], TRACE[kind]

    class App(http.JsonHandler):
        trace_service = "svc"
        self_url = ""

        def log_message(self, fmt, *args):
            pass

    def fan(h, path, q, body):
        # the outbound call carries this span, so the hop parents under it
        st, _ = http.http_bytes("GET", f"http://{App.self_url}/ping")
        return 200, {"child": st}

    def stream(h, path, q, body):
        pieces = [b"ab" * 8, b"cd" * 8]
        return 200, http.StreamBody(sum(len(p) for p in pieces), iter(pieces))

    App.routes = [("GET", "/ping", lambda h, p, q, b: (200, {"ok": True})),
                  ("GET", "/fan", fan), ("GET", "/stream", stream)]
    monkeypatch.setenv("SWEED_SERVING", mode)
    srv = http.start_server(App, "127.0.0.1", free_port())
    monkeypatch.delenv("SWEED_SERVING")
    App.self_url = "%s:%d" % srv.server_address[:2]
    try:
        shapes = []
        for path in ("/fan", "/stream"):
            st, _, hdrs = http.http_bytes_headers("GET", f"http://{App.self_url}{path}")
            assert st == 200
            tid = {k.lower(): v for k, v in hdrs.items()}["x-sweed-trace-id"]
            want = 2 if path == "/fan" else 1
            end = time.monotonic() + 5
            while len(trace.RING.for_trace(tid)) < want and time.monotonic() < end:
                time.sleep(0.01)
            shape = []

            def walk(node, depth):
                shape.append((node["service"], node["name"], depth))
                for c in node["children"]:
                    walk(c, depth + 1)

            for root in trace.assemble_tree(trace.RING.for_trace(tid)):
                walk(root, 0)
            shapes.append(shape)
    finally:
        if kind == "jax":  # its asyncio core lingers ~10 s on a pooled peer
            threading.Thread(target=srv.server_close, daemon=True).start()
        else:
            srv.server_close()
    return shapes


def test_threads_and_aio_emit_identical_span_trees(monkeypatch):
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    expected = [[("svc", "GET /fan", 0), ("svc", "GET /ping", 1)], [("svc", "GET /stream", 0)]]
    for kind in KINDS:
        for mode in ("threads", "aio"):
            assert _span_tree_shape(kind, mode, monkeypatch) == expected, (kind, mode)


# -- end to end on a port cluster ----------------------------------------------------
def collect(urls, tid):
    """The trace's spans from each daemon's ring, as the shell's ``trace``
    collects them (each daemon runs the ring's route at its own path)."""
    spans = []
    for url, route in urls:
        r = http_json("GET", f"http://{url}{route}?trace={tid}")
        spans.extend(r["spans"])
    return spans


@pytest.fixture(params=["threads", "aio"])
def cluster(request, tmp_path, monkeypatch):
    monkeypatch.setenv("SWEED_SERVING", request.param)
    monkeypatch.setenv("SWEED_TURBO", "0")  # the engine serves fids without spans
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volumes = [VolumeServer([str(tmp_path / f"srv{i}")], port=free_port(),
                            master_url=master.url, pulse_seconds=0.5,
                            ec_backend="cpu").start() for i in range(2)]
    filer = FilerServer(port=free_port(), master_url=master.url, chunk_size=64 * 1024,
                        query_backend="cpu").start()
    end = time.monotonic() + 10
    while time.monotonic() < end and len(http_json(
            "GET", f"http://{master.url}/dir/status")["topology"]["data_centers"][0]
            ["racks"][0]["nodes"]) < 2:
        time.sleep(0.1)
    daemons = [(master.url, "/debug/traces"), (filer.url, "/_debug/traces")] + [
        (f"{v.host}:{v.port}", "/debug/traces") for v in volumes]
    yield master, volumes, filer, daemons
    filer.stop()
    for v in volumes:
        v.stop()
    master.stop()


def settle(daemons, tid, want):
    end = time.monotonic() + 10
    while time.monotonic() < end:
        spans = collect(daemons, tid)
        if want <= {s["service"] for s in spans}:
            return spans
        time.sleep(0.05)
    return collect(daemons, tid)


def test_cluster_trace_tree_filer_master_volume(cluster):
    master, volumes, filer, daemons = cluster
    blob = os.urandom(200_000)  # 4 chunks: assign and volume hops
    st, _, hdrs = http_bytes_headers("POST", f"http://{filer.url}/t/trace.bin", blob)
    assert st == 201
    put_tid = {k.lower(): v for k, v in hdrs.items()}["x-sweed-trace-id"]
    st, data, hdrs = http_bytes_headers("GET", f"http://{filer.url}/t/trace.bin")
    assert st == 200 and data == blob
    get_tid = {k.lower(): v for k, v in hdrs.items()}["x-sweed-trace-id"]

    put_spans = settle(daemons, put_tid, {"filer", "master", "volume"})
    assert {"filer", "master", "volume"} <= {s["service"] for s in put_spans}, put_spans
    roots = p_trace.assemble_tree(put_spans)  # dedups the shared ring
    assert len(roots) == 1 and roots[0]["service"] == "filer"
    ids = {s["span_id"] for s in put_spans}
    assert all(s["parent_id"] in ids for s in put_spans if s["span_id"] != roots[0]["span_id"])
    tree = p_trace.format_tree(roots)
    assert tree.splitlines()[0].startswith("filer ") and "master" in tree and "volume" in tree

    get_spans = settle(daemons, get_tid, {"filer", "volume"})
    roots = p_trace.assemble_tree(get_spans)
    assert len(roots) == 1 and roots[0]["service"] == "filer"

    vs = http_json("GET", f"http://{volumes[0].host}:{volumes[0].port}/status")
    assert vs["trace"]["enabled"] is True and "request_latency" in vs
    assert http_json("GET", f"http://{master.url}/dir/status")["trace"]["added"] >= 1
    fs = http_json("GET", f"http://{filer.url}/_status")
    assert fs["trace"]["enabled"] is True and isinstance(fs["deadline"], dict)
    st, payload, _ = http_bytes_headers("GET", f"http://{master.url}/metrics")
    assert st == 200 and "master_assign_seconds_bucket" in payload.decode()


@pytest.mark.parametrize("gateway", KINDS)
def test_gateway_trace_crosses_into_the_port_filer(cluster, gateway):
    """An S3 PUT and GET through either package's gateway over the port's
    filer: one tree each, rooted at the gateway's span, with the filer's
    and a volume server's spans under it."""
    _, _, filer, daemons = cluster
    server = JS3ApiServer if gateway == "jax" else PS3ApiServer
    api = server(port=free_port(), filer_url=filer.url).start()
    try:
        c = S3Client(f"http://{api.url}")
        assert c.create_bucket("tr")[0] == 200
        blob = os.urandom(150_000)
        for method, args in (("put", ("tr", "o.bin", blob)), ("get", ("tr", "o.bin"))):
            st, data, hdrs = getattr(c, f"{method}_object")(*args)
            assert st == 200 and (method == "put" or data == blob)
            tid = {k.lower(): v for k, v in hdrs.items()}["x-sweed-trace-id"]
            spans = settle(daemons, tid, {"filer", "volume"} if gateway == "jax"
                           else {"s3", "filer", "volume"})
            if gateway == "jax":  # the JAX package's gateway keeps its own ring
                spans += j_trace.RING.for_trace(tid)
            assert {"s3", "filer", "volume"} <= {s["service"] for s in spans}, spans
            roots = p_trace.assemble_tree(spans)
            assert len(roots) == 1 and roots[0]["service"] == "s3", roots
    finally:
        stop_jax_server(api) if gateway == "jax" else api.stop()


def test_engine_passes_trace_and_deadline_headers_through(tmp_path, monkeypatch):
    """With the native engine on the volume server's public port, a request
    it proxies to the daemon keeps its ``X-Sweed-Trace`` (the daemon's span
    joins the caller's trace) and its ``X-Sweed-Deadline`` (a spent one is
    answered 504)."""
    import http.client

    monkeypatch.delenv("SWEED_TURBO", raising=False)
    master = MasterServer(port=free_port(), node_timeout=60).start()
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.5, ec_backend="cpu").start()
    try:
        assert vs.turbo is not None, vs.turbo_status()
        replies = []
        for extra in ({"X-Sweed-Trace": "feedfacefeedface:cafe0001"},
                      {"X-Sweed-Deadline": f"{time.time() - 2:.6f}"}):
            c = http.client.HTTPConnection("127.0.0.1", vs.port, timeout=10)
            c.request("GET", "/status", headers=extra)
            r = c.getresponse()
            replies.append((r.status, r.getheader("X-Sweed-Trace-Id")))
            r.read()
            c.close()
        assert replies[0] == (200, "feedfacefeedface")
        assert replies[1][0] == 504
        spans = p_trace.RING.for_trace("feedfacefeedface")
        assert [(s["service"], s["parent_id"]) for s in spans] == [("volume", "cafe0001")]
    finally:
        vs.stop()
        master.stop()
