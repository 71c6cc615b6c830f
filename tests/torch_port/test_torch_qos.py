"""The request choke point's tenant governor and deadlines: the port's
against the JAX package's.

The cases of the reference's ``tests/test_qos.py`` and the deadline half of
``tests/test_hedge_deadline.py``, each run on both packages (``kind``) with
the reference's assertions; where a case serves requests, both packages'
servers answer the same request sequence with the same statuses. The
governor and the deadline counters are process-wide in each package, so
every case resets its package's governor.
"""

from __future__ import annotations

import asyncio
import socket
import time
import urllib.error
import urllib.request

import pytest

import seaweedfs_tpu.server.aio_transport as j_aio_transport
import seaweedfs_tpu.server.http_util as j_http
import seaweedfs_tpu.stats.metrics as j_metrics
import seaweedfs_tpu.util.deadline as j_deadline
import seaweedfs_tpu.util.throttler as j_throttler
import seaweedfs_tpu_torch.server.aio_transport as p_aio_transport
import seaweedfs_tpu_torch.server.http_util as p_http
import seaweedfs_tpu_torch.stats.metrics as p_metrics
import seaweedfs_tpu_torch.util.deadline as p_deadline
import seaweedfs_tpu_torch.util.throttler as p_throttler
from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer

from s3_pair import KINDS, free_port

PKG = {
    "jax": dict(throttler=j_throttler, http=j_http, aio_transport=j_aio_transport,
                metrics=j_metrics, deadline=j_deadline, master=JMasterServer),
    "port": dict(throttler=p_throttler, http=p_http, aio_transport=p_aio_transport,
                 metrics=p_metrics, deadline=p_deadline, master=PMasterServer),
}


@pytest.fixture(params=KINDS)
def pkg(request):
    p = PKG[request.param]
    p["throttler"].GOVERNOR.reset()
    yield p
    p["throttler"].GOVERNOR.reset()


# -- TokenBucket ---------------------------------------------------------------
def test_bucket_burst_then_shed(pkg):
    b = pkg["throttler"].TokenBucket(rate=10.0, burst=3.0)
    assert [b.reserve(1.0, 0.0) for _ in range(3)] == [0.0, 0.0, 0.0]
    assert b.reserve(1.0, 0.0) is None  # the burst is spent, no wait allowed


def test_bucket_pacing_delay_takes_debt(pkg):
    b = pkg["throttler"].TokenBucket(rate=10.0, burst=1.0)
    assert b.reserve(1.0, 1.0) == 0.0
    w1 = b.reserve(1.0, 1.0)
    w2 = b.reserve(1.0, 1.0)
    # both paced, and the second queues behind the first's debt
    assert w1 and w2 and w2 > w1
    assert b.reserve(1.0, 0.15) is None  # the next would owe ~0.3 s


def test_bucket_refills_to_burst_cap(pkg):
    b = pkg["throttler"].TokenBucket(rate=1000.0, burst=2.0)
    b.reserve(2.0, 0.0)
    time.sleep(0.05)  # 50 tokens earned, capped at the burst
    assert b.reserve(2.0, 0.0) == 0.0
    assert b.reserve(1.0, 0.0) is None


def test_bucket_set_rate_clamps_tokens(pkg):
    b = pkg["throttler"].TokenBucket(rate=1.0, burst=100.0)
    b.set_rate(1.0, 2.0)
    assert b.reserve(2.0, 0.0) == 0.0
    assert b.reserve(1.0, 0.0) is None


# -- tenant classification -------------------------------------------------------
@pytest.mark.parametrize("headers,addr,want", [
    ({"X-Sweed-Internal": "1"}, "10.0.0.9", "internal"),
    ({"X-Sweed-Tenant": "acme"}, "10.0.0.9", "hdr:acme"),
    ({"Authorization": "AWS4-HMAC-SHA256 Credential=AKID/20260808/us/s3/aws4_request,"
                       " SignedHeaders=host, Signature=ab"}, "10.0.0.9", "ak:AKID"),
    ({"Authorization": "AWS AKOLD:c2ln"}, "10.0.0.9", "ak:AKOLD"),
    ({}, "203.0.113.77", "ip:203.0.113"),
    ({}, "2001:db8:cafe::1", "ip:2001:db8:cafe"),
    # the internal marker beats everything
    ({"X-Sweed-Internal": "1", "X-Sweed-Tenant": "acme", "Authorization": "AWS AK:sig"},
     "1.2.3.4", "internal"),
])
def test_classify_tenant(pkg, headers, addr, want):
    assert pkg["throttler"].classify_tenant(lambda k, d="": headers.get(k, d), addr) == want


# -- the governor --------------------------------------------------------------------
def test_governor_disabled_admits_everything(pkg, monkeypatch):
    monkeypatch.delenv("SWEED_QOS_RPS", raising=False)
    assert not pkg["throttler"].GOVERNOR.enabled()
    assert pkg["throttler"].GOVERNOR.admit("hdr:anyone") == ("ok", 0.0)


def test_governor_internal_always_bypasses(pkg, monkeypatch):
    monkeypatch.setenv("SWEED_QOS_RPS", "1")
    monkeypatch.setenv("SWEED_QOS_MAX_DELAY_MS", "0")
    for _ in range(50):
        assert pkg["throttler"].GOVERNOR.admit(pkg["throttler"].INTERNAL_TENANT) == ("ok", 0.0)


def test_governor_sheds_past_burst_with_zero_delay(pkg, monkeypatch):
    monkeypatch.setenv("SWEED_QOS_RPS", "2")
    monkeypatch.setenv("SWEED_QOS_MAX_DELAY_MS", "0")
    gov = pkg["throttler"].GOVERNOR
    outcomes = [gov.admit("hdr:greedy")[0] for _ in range(20)]
    assert outcomes.count("ok") >= 2  # the one-second burst allowance
    assert outcomes[-1] == "shed"
    snap = gov.snapshot()
    t = snap["tenants"]["hdr:greedy"]
    assert t["shed"] > 0 and t["admitted"] >= 2
    assert snap["shed_total"] == t["shed"]


def test_governor_weighted_fair_shares(pkg, monkeypatch):
    monkeypatch.setenv("SWEED_QOS_RPS", "300")
    monkeypatch.setenv("SWEED_QOS_WEIGHTS", "hdr:gold=2,*=1")
    gov = pkg["throttler"].GOVERNOR
    gov.admit("hdr:gold")
    gov.admit("hdr:bronze")
    gov.admit("hdr:gold")  # the recompute sees both active
    snap = gov.snapshot()["tenants"]
    assert snap["hdr:gold"]["weight"] == 2.0
    assert snap["hdr:gold"]["rate"] == pytest.approx(200.0)
    assert snap["hdr:bronze"]["rate"] == pytest.approx(100.0)


def test_governor_bounded_tenant_cardinality(pkg, monkeypatch):
    monkeypatch.setenv("SWEED_QOS_RPS", "1")
    monkeypatch.setenv("SWEED_QOS_MAX_DELAY_MS", "0")
    monkeypatch.setattr(pkg["throttler"].TenantGovernor, "MAX_TENANTS", 4)
    gov = pkg["throttler"].GOVERNOR
    for i in range(16):
        for _ in range(6):  # past the burst: some sheds per tenant
            gov.admit(f"ip:10.0.{i}")
    snap = gov.snapshot()
    assert len(snap["tenants"]) <= 4
    assert snap["shed_total"] >= sum(t["shed"] for t in snap["tenants"].values())


# -- shed semantics on the wire ----------------------------------------------------
def _app(http):
    class App(http.JsonHandler):
        def log_message(self, fmt, *args):
            pass

    App.routes = [
        ("GET", "/ping", lambda h, path, q, body: (200, {"ok": True})),
        ("GET", "/hdr", lambda h, path, q, body: (
            200, {"internal": h.headers.get("X-Sweed-Internal", "")})),
        ("GET", "/blob", lambda h, path, q, body: (200, b"\xfeBLOB" * 300)),
    ]
    return App


def _raw_request(sock, path, extra=""):
    sock.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\nContent-Length: 0\r\n{extra}\r\n".encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        got = sock.recv(65536)
        if not got:
            raise ConnectionError("EOF in headers")
        buf += got
    head, body = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    hdrs = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    want = int(hdrs.get("content-length", "0"))
    while len(body) < want:
        got = sock.recv(65536)
        if not got:
            break
        body += got
    return status, hdrs, body


@pytest.mark.parametrize("mode", ["threads", "aio"])
def test_shed_503_keeps_connection_alive(mode, monkeypatch):
    """A shed answers 503 + Retry-After on the same socket, which stays
    alive; internal traffic bypasses the saturated tenant. Both packages
    answer the same sequence alike."""
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    monkeypatch.setenv("SWEED_QOS_RPS", "1")
    monkeypatch.setenv("SWEED_QOS_MAX_DELAY_MS", "0")
    monkeypatch.setenv("SWEED_SERVING", mode)
    seqs = {}
    for kind in KINDS:
        p = PKG[kind]
        p["throttler"].GOVERNOR.reset()
        srv = p["http"].start_server(_app(p["http"]), "127.0.0.1", free_port())
        host, port = srv.server_address[:2]
        try:
            c = socket.create_connection((host, port), timeout=10)
            try:
                statuses = []
                for _ in range(12):
                    st, hdrs, body = _raw_request(c, "/ping", extra="X-Sweed-Tenant: greedy\r\n")
                    statuses.append((st, body))
                    if st == 503:
                        assert int(hdrs["retry-after"]) >= 1
                        assert hdrs.get("connection") != "close"
                st, _, body = _raw_request(c, "/ping", extra="X-Sweed-Internal: 1\r\n")
                assert st == 200 and b'"ok"' in body
            finally:
                c.close()
            assert p["throttler"].GOVERNOR.snapshot()["tenants"]["hdr:greedy"]["shed"] > 0
        finally:
            srv.server_close()
            p["throttler"].GOVERNOR.reset()
        seqs[kind] = statuses
        assert 503 in [s for s, _ in statuses] and [s for s, _ in statuses].count(200) >= 1
    # the burst allowance admits the same count; every 503 body is the same
    assert seqs["port"] == seqs["jax"]


def test_qos_metrics_quantiles_per_tenant(pkg, monkeypatch):
    """QoS is read off /metrics: the per-tenant latency histogram and the
    decision counters move."""
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    monkeypatch.setenv("SWEED_QOS_RPS", "1")
    monkeypatch.setenv("SWEED_QOS_MAX_DELAY_MS", "0")
    monkeypatch.setenv("SWEED_SERVING", "threads")
    srv = pkg["http"].start_server(_app(pkg["http"]), "127.0.0.1", free_port())
    host, port = srv.server_address[:2]
    try:
        c = socket.create_connection((host, port), timeout=10)
        try:
            for _ in range(8):
                _raw_request(c, "/ping", extra="X-Sweed-Tenant: m\r\n")
        finally:
            c.close()
    finally:
        srv.server_close()
    text = pkg["metrics"].default_registry.expose()
    assert "sweed_qos_request_seconds_bucket{" in text
    assert 'tenant="hdr:m"' in text
    assert 'sweed_qos_decisions_total{outcome="shed",tenant="hdr:m"}' in text
    assert "sweed_serving_qos_shed_total" in text


# -- the asyncio transport ------------------------------------------------------------
def test_aio_transport_request_and_internal_marking(pkg, monkeypatch):
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    monkeypatch.setenv("SWEED_SERVING", "threads")
    srv = pkg["http"].start_server(_app(pkg["http"]), "127.0.0.1", free_port())
    host, port = srv.server_address[:2]
    aio = pkg["aio_transport"]
    try:
        async def go():
            st, body, _ = await aio.request("GET", f"http://{host}:{port}/hdr")
            st2, blob, _ = await aio.request("GET", f"http://{host}:{port}/blob")
            return st, body, st2, blob, aio.pool_stats()

        st, body, st2, blob, pooled = asyncio.run(go())
        assert st == 200 and b'"internal": "1"' in body  # every hop is internal
        assert st2 == 200 and blob == b"\xfeBLOB" * 300
        assert any(per_loop.get(f"{host}:{port}", 0) >= 1 for per_loop in pooled.values())
    finally:
        srv.server_close()


def test_aio_transport_stream_reads_and_repools(pkg, monkeypatch):
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    monkeypatch.setenv("SWEED_SERVING", "threads")
    srv = pkg["http"].start_server(_app(pkg["http"]), "127.0.0.1", free_port())
    host, port = srv.server_address[:2]
    want = b"\xfeBLOB" * 300
    aio = pkg["aio_transport"]
    try:
        async def go():
            st, data, _ = await aio.stream("GET", f"http://{host}:{port}/blob")
            assert st == 200 and data.length == len(want)
            got = b""
            while piece := await data.read(256):
                got += piece
            return got, aio.pool_stats()

        got, pooled = asyncio.run(go())
        assert got == want
        # a drained stream hands its socket back to the pool
        assert any(per_loop.get(f"{host}:{port}", 0) >= 1 for per_loop in pooled.values())
    finally:
        srv.server_close()


# -- deadline primitives (the deadline half of test_hedge_deadline.py) ---------------
def test_scope_sets_and_restores(pkg):
    deadline = pkg["deadline"]
    assert deadline.current() is None
    d = deadline.after(5)
    with deadline.scope(d):
        assert deadline.current() == d
        r = deadline.remaining()
        assert r is not None and 4 < r <= 5
        with deadline.scope(None):  # None nests transparently
            assert deadline.current() == d
    assert deadline.current() is None


def test_clamp_timeout(pkg):
    deadline = pkg["deadline"]
    assert deadline.clamp_timeout(30.0) == 30.0
    with deadline.scope(deadline.after(1.0)):
        t = deadline.clamp_timeout(30.0)
        assert deadline.MIN_TIMEOUT <= t <= 1.0
    assert deadline.counts().get("clamped", 0) >= 1
    with deadline.scope(time.time() - 1.0):
        assert deadline.expired()
        with pytest.raises(deadline.DeadlineExceeded):
            deadline.clamp_timeout(30.0)
    assert deadline.counts().get("refused_dial", 0) >= 1


def test_header_round_trip_and_garbage(pkg):
    deadline = pkg["deadline"]
    d = deadline.after(10)
    with deadline.scope(d):
        v = deadline.inject_header()
    assert v is not None and deadline.parse_header(v) == pytest.approx(d, abs=1e-5)
    for bad in (None, "", "soon", "nan", "inf", "-5", "1e20", "42"):
        assert deadline.parse_header(bad) is None
    assert deadline.inject_header() is None


@pytest.mark.parametrize("mode", ["threads", "aio"])
def test_inbound_deadline_on_a_live_master(pkg, mode, monkeypatch):
    """A spent X-Sweed-Deadline answers 504 without running the handler
    (counted as ``expired_inbound``); a live one passes through."""
    monkeypatch.setenv("SWEED_SERVING", mode)
    deadline = pkg["deadline"]
    m = pkg["master"](port=free_port(), node_timeout=60).start()
    try:
        before = deadline.counts().get("expired_inbound", 0)
        req = urllib.request.Request(f"http://{m.url}/dir/status")
        req.add_header(deadline.DEADLINE_HEADER, f"{time.time() - 2:.6f}")
        with pytest.raises(urllib.error.HTTPError) as ei:
            with urllib.request.urlopen(req, timeout=10):
                pass
        assert ei.value.code == 504
        assert b"deadline exceeded" in ei.value.read()
        assert deadline.counts()["expired_inbound"] == before + 1
        req = urllib.request.Request(f"http://{m.url}/dir/status")
        req.add_header(deadline.DEADLINE_HEADER, f"{time.time() + 30:.6f}")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
    finally:
        m.stop()


def test_outbound_transport_injects_header(pkg):
    deadline = pkg["deadline"]
    with deadline.scope(deadline.after(30)):
        hdrs = pkg["http"]._trace_headers({}) or {}
    assert deadline.DEADLINE_HEADER in hdrs


def test_spent_budget_refuses_the_dial(pkg):
    """Under a spent budget the pooled transport puts nothing on the wire."""
    deadline = pkg["deadline"]
    with deadline.scope(time.time() - 1.0):
        with pytest.raises(deadline.DeadlineExceeded):
            pkg["http"].http_bytes("GET", "http://127.0.0.1:1/x")
