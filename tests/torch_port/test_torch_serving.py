"""The port's serving cores against the JAX package's: the shutdown race,
admission control, threads-vs-aio wire parity, and the zero-copy sendfile
read path.

The cases of the reference's ``tests/test_serving.py`` that cover what the
port serves, run against both packages where the reference has the case,
over raw sockets (admission rejections and keep-alive shedding happen below
``http.client``). Replies are compared with ``Date`` and the
trace-id header removed (a random id per request); everything else is exact.
"""

import os
import socket
import struct
import threading
import time

import pytest

import seaweedfs_tpu.server.http_util as j_http
import seaweedfs_tpu.server.volume_server as j_vs
import seaweedfs_tpu_torch.server.http_util as p_http
import seaweedfs_tpu_torch.server.volume_server as p_vs
from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu.storage.needle import FLAG_HAS_MIME, FLAG_HAS_NAME
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.volume import Volume as PVolume
from serving_pair import free_port

HTTP = {"jax": j_http, "port": p_http}
PACKAGES = ("jax", "port")


def _app(http):
    """A minimal route table over every reply shape the cores share."""

    class App(http.JsonHandler):
        gate = threading.Event()  # /slow parks here

        def log_message(self, fmt, *args):
            pass

    def ping(h, path, q, body):
        return 200, {"ok": True, "q": q.get("x", "")}

    def blob(h, path, q, body):
        return 200, b"\x00\x01binary\xff" * 40

    def echo(h, path, q, body):
        return 200, body

    def stream(h, path, q, body):
        pieces = [b"abc" * 10, b"defgh" * 6, b"z" * 7]
        return 200, http.StreamBody(sum(len(p) for p in pieces), iter(pieces))

    def slow(h, path, q, body):
        App.gate.wait(10)
        return 200, {"slept": True}

    def boom(h, path, q, body):
        raise RuntimeError("handler exploded")

    App.routes = [("GET", "/ping", ping), ("GET", "/blob", blob), ("HEAD", "/blob", blob),
                  ("POST", "/echo", echo), ("GET", "/stream", stream),
                  ("GET", "/slow", slow), ("GET", "/boom", boom)]
    return App


APPS = {k: _app(m) for k, m in HTTP.items()}


def _recv_response(sock, head_only=False):
    buf = b""
    while b"\r\n\r\n" not in buf:
        got = sock.recv(65536)
        if not got:
            raise ConnectionError(f"EOF in headers: {buf!r}")
        buf += got
    head, body = buf.split(b"\r\n\r\n", 1)
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    want = 0 if head_only else int(headers.get("content-length", "0"))
    while len(body) < want:
        got = sock.recv(65536)
        if not got:
            break
        body += got
    return status, headers, body


def _request(sock, method, path, body=b"", extra=""):
    sock.sendall((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n{extra}\r\n").encode() + body)
    return _recv_response(sock, head_only=(method == "HEAD"))


@pytest.fixture
def serving_env(monkeypatch):
    monkeypatch.setenv("SWEED_MAX_INFLIGHT", "8192")
    monkeypatch.delenv("SWEED_SERVING", raising=False)
    return monkeypatch


def _start_app(pkg, mode, monkeypatch):
    monkeypatch.setenv("SWEED_SERVING", mode)
    try:
        return HTTP[pkg].start_server(APPS[pkg], "127.0.0.1", free_port())
    finally:
        monkeypatch.delenv("SWEED_SERVING")


def test_defaults_are_the_reference_defaults(serving_env):
    for name in ("serving_mode", "serving_watermark", "retry_after_seconds",
                 "sendfile_min_bytes", "pool_max_idle_seconds"):
        assert getattr(p_http, name)() == getattr(j_http, name)(), name
    assert p_http.serving_mode() == "aio" and p_http.serving_watermark() == 8192
    assert p_http.sendfile_min_bytes() == 65536
    for raw in ("threads", "THREADS", "aio", "junk"):
        serving_env.setenv("SWEED_SERVING", raw)
        assert p_http.serving_mode() == j_http.serving_mode()
    for raw in ("0", "-3", "zz", "17"):
        serving_env.setenv("SWEED_MAX_INFLIGHT", raw)
        serving_env.setenv("SWEED_SENDFILE_MIN", raw)
        assert p_http.serving_watermark() == j_http.serving_watermark()
        assert p_http.sendfile_min_bytes() == j_http.sendfile_min_bytes()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_shutdown_then_late_accept_closes_not_registers(serving_env, pkg):
    srv = _start_app(pkg, "threads", serving_env)
    try:
        srv.shutdown()
        a, b = socket.socketpair()
        try:
            srv.process_request(a, ("127.0.0.1", 0))
            assert a.fileno() == -1
            assert srv.inflight_count() == 0
            b.settimeout(2)
            assert b.recv(1) == b""
        finally:
            b.close()
    finally:
        srv.server_close()


# the JAX reactor awaits server.wait_closed() before it severs, and on
# Python 3.12 that waits for the idle keep-alive peer itself: its case is
# the threads core only, as in the reference's own test
@pytest.mark.parametrize("pkg,mode", [("jax", "threads"), ("port", "threads"),
                                      ("port", "aio")])
def test_shutdown_severs_established_keepalive(serving_env, pkg, mode):
    srv = _start_app(pkg, mode, serving_env)
    host, port = srv.server_address[:2]
    c = socket.create_connection((host, port), timeout=5)
    try:
        assert _request(c, "GET", "/ping")[0] == 200
        t0 = time.monotonic()
        srv.shutdown()
        c.settimeout(5)
        assert c.recv(1) == b""
        assert time.monotonic() - t0 < 5
    finally:
        c.close()
        srv.server_close()


@pytest.mark.parametrize("mode", ["threads", "aio"])
@pytest.mark.parametrize("pkg", PACKAGES)
def test_admission_watermark_503_and_recovery(serving_env, pkg, mode):
    serving_env.setenv("SWEED_MAX_INFLIGHT", "2")
    serving_env.setenv("SWEED_RETRY_AFTER", "7")
    app = APPS[pkg]
    app.gate = threading.Event()
    srv = _start_app(pkg, mode, serving_env)
    host, port = srv.server_address[:2]
    conns = []
    try:
        for _ in range(2):
            c = socket.create_connection((host, port), timeout=10)
            c.sendall(b"GET /slow HTTP/1.1\r\nHost: t\r\nContent-Length: 0\r\n\r\n")
            conns.append(c)
        deadline = time.monotonic() + 5
        while srv.inflight_count() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.inflight_count() >= 2
        c3 = socket.create_connection((host, port), timeout=10)
        st, hdrs, body = _recv_response(c3)
        assert st == 503 and int(hdrs["retry-after"]) >= 7
        assert hdrs["connection"] == "close" and body == b""
        c3.settimeout(5)
        assert c3.recv(1) == b""
        c3.close()
        app.gate.set()
        shed = []
        for c in conns:
            st, hdrs, body = _recv_response(c)
            assert st == 200 and b'"slept": true' in body
            shed.append(hdrs.get("connection") == "close")
        assert any(shed), "a reply at the watermark must shed keep-alive"
        for c in conns:
            c.close()
        conns.clear()
        deadline = time.monotonic() + 5
        while srv.inflight_count() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        c4 = socket.create_connection((host, port), timeout=10)
        st, hdrs, _ = _request(c4, "GET", "/ping")
        assert st == 200 and hdrs.get("connection") != "close"
        c4.close()
    finally:
        for c in conns:
            c.close()
        app.gate.set()
        srv.server_close()


def test_serving_status_counters_move(serving_env):
    serving_env.setenv("SWEED_MAX_INFLIGHT", "1")
    app = APPS["port"]
    app.gate = threading.Event()
    srv = _start_app("port", "threads", serving_env)
    host, port = srv.server_address[:2]
    before = p_http.SERVING.snapshot()
    c1 = socket.create_connection((host, port), timeout=10)
    try:
        c1.sendall(b"GET /slow HTTP/1.1\r\nHost: t\r\nContent-Length: 0\r\n\r\n")
        deadline = time.monotonic() + 5
        while srv.inflight_count() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        c2 = socket.create_connection((host, port), timeout=10)
        assert _recv_response(c2)[0] == 503
        c2.close()
        app.gate.set()
        _recv_response(c1)
        after = p_http.SERVING.snapshot()
        assert after["admission_rejected"] > before["admission_rejected"]
        assert after["keepalive_shed"] > before["keepalive_shed"]
        assert set(after) >= {"mode", "watermark", "inflight", "loop_lag_ms",
                              "native_hits", "request_p99_ms"}
    finally:
        app.gate.set()
        c1.close()
        srv.server_close()


def _collect_wire(pkg, mode, monkeypatch):
    APPS[pkg].gate.set()
    srv = _start_app(pkg, mode, monkeypatch)
    host, port = srv.server_address[:2]
    out = []
    try:
        c = socket.create_connection((host, port), timeout=10)
        try:
            for method, path, body in [
                ("GET", "/ping?x=1", b""), ("GET", "/blob", b""), ("HEAD", "/blob", b""),
                ("POST", "/echo", b"payload \x00bytes" * 9), ("GET", "/stream", b""),
                ("GET", "/nope", b""), ("GET", "/boom", b""), ("GET", "/ping", b""),
            ]:
                st, hdrs, rbody = _request(c, method, path, body)
                hdrs.pop("date", None)
                hdrs.pop("x-sweed-trace-id", None)
                out.append((method, path, st, sorted(hdrs.items()), rbody))
        finally:
            c.close()
    finally:
        srv.server_close()
    return out


def test_aio_threads_wire_parity(serving_env):
    """The reactor runs the handler class unmodified: every reply (JSON,
    raw bytes, streamed, 404, a handler's 500) is the same bytes as the
    threads core's, and the same as the JAX package's."""
    port_threads = _collect_wire("port", "threads", serving_env)
    assert port_threads == _collect_wire("port", "aio", serving_env)
    assert port_threads == _collect_wire("jax", "threads", serving_env)


# -- the sendfile read path ----------------------------------------------------
def _volume_node(pkg, directory, monkeypatch, mode="aio", assign=True):
    """A master and a volume server of ``pkg`` with the engine off, so GETs
    run the Python handler, where the sendfile path lives."""
    monkeypatch.setenv("SWEED_TURBO", "0")
    monkeypatch.setenv("SWEED_SERVING", mode)
    master = (JMasterServer if pkg == "jax" else PMasterServer)(
        port=free_port(), node_timeout=60).start()
    vcls = j_vs.VolumeServer if pkg == "jax" else p_vs.VolumeServer
    backend = "numpy" if pkg == "jax" else "cpu"
    vs = vcls([directory], port=free_port(), master_url=master.url, pulse_seconds=0.5,
              ec_backend=backend).start()
    assert vs.turbo is None
    if not assign:
        return master, vs
    status, body = p_http.http_bytes("POST", f"http://127.0.0.1:{vs.port}"
                                             f"/admin/assign_volume?volume=4")
    assert status == 200, body
    return master, vs


def _stop(master, vs):
    vs.stop()
    if isinstance(master, PMasterServer):
        master.stop()
    else:
        threading.Thread(target=master.stop, daemon=True).start()


def _spy_sendfile(vs):
    calls, files = [], []
    real = vs._sendfile_reply

    def spy(h, q, n, ext):
        files.append(ext[0])
        r = real(h, q, n, ext)
        if r is not None:
            calls.append(n.id)
        return r

    vs._sendfile_reply = spy
    return calls, files


BIG = os.urandom(200_000)
SMALL = os.urandom(1000)
TEXT = b"wire parity! " * 20_000


def _upload(url):
    import gzip

    for key, body, hdrs in ((0x11, BIG, {}), (0x12, SMALL, {}),
                            (0x13, gzip.compress(TEXT, mtime=0),
                             {"Content-Encoding": "gzip", "X-Sweed-Name": "t.txt",
                              "X-Sweed-Mime": "text/plain"})):
        st, _ = p_http.http_bytes("POST", f"http://{url}/4,{key:x}00000abc", body,
                                  headers=hdrs)
        assert st == 201


READS = [
    ("GET", "/4,1100000abc", ""),
    ("HEAD", "/4,1100000abc", ""),
    ("GET", "/4,1100000abc", "Range: bytes=1000-60999\r\n"),
    ("GET", "/4,1100000abc", "Range: bytes=5000-\r\n"),
    ("GET", "/4,1100000abc", "Range: bytes=999999-\r\n"),
    ("GET", "/4,1200000abc", ""),
    ("GET", "/4,1300000abc", ""),
    ("GET", "/4,1300000abc", "Accept-Encoding: gzip\r\n"),
    ("HEAD", "/4,1300000abc", ""),
    ("GET", "/4,1100000bbb", ""),  # wrong cookie
    ("GET", "/4,1f00000abc", ""),  # missing
]


def _collect_conn(port, reqs):
    out = []
    c = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        for method, path, extra in reqs:
            st, hdrs, body = _request(c, method, path, extra=extra)
            hdrs.pop("date", None)
            hdrs.pop("x-sweed-trace-id", None)
            out.append((method, path, extra, st, sorted(hdrs.items()), body))
    finally:
        c.close()
    return out


def test_sendfile_reads_equal_buffered_and_the_reference(tmp_path, monkeypatch):
    """Zero-copy GETs and range reads give the bytes buffered ones give; the
    floor keeps small needles buffered; ``SWEED_SENDFILE=0`` turns the path
    off; and the port's wire transcript is the JAX package's."""
    wires = {}
    for pkg in PACKAGES:
        master, vs = _volume_node(pkg, str(tmp_path / pkg), monkeypatch)
        try:
            _upload(f"127.0.0.1:{vs.port}")
            calls, _ = _spy_sendfile(vs)
            wires[pkg] = _collect_conn(vs.port, READS)
            if pkg == "port":
                assert 0x11 in calls and 0x12 not in calls, calls
                assert wires[pkg][0][3:] == (200, wires[pkg][0][4], BIG)
                assert wires[pkg][2][5] == BIG[1000:61000]
                calls.clear()
                monkeypatch.setenv("SWEED_SENDFILE", "0")
                assert _collect_conn(vs.port, READS) == wires[pkg]
                assert not calls, "SWEED_SENDFILE=0 must disable the path"
                monkeypatch.delenv("SWEED_SENDFILE")
        finally:
            _stop(master, vs)
    assert wires["port"] == wires["jax"]


def test_native_volume_wire_parity_threads_vs_aio(tmp_path, monkeypatch):
    """The native GET/HEAD coroutine of the aio core gives the threads
    core's bytes on the wire, for the same store; and it serves natively."""
    d = str(tmp_path / "v")
    master, vs = _volume_node("port", d, monkeypatch, mode="aio")
    try:
        _upload(f"127.0.0.1:{vs.port}")
        before = p_http.SERVING.snapshot()["native_hits"]
        wire_aio = _collect_conn(vs.port, READS)
        assert p_http.SERVING.snapshot()["native_hits"] > before
    finally:
        _stop(master, vs)
    master, vs = _volume_node("port", d, monkeypatch, mode="threads", assign=False)
    try:
        wire_thr = _collect_conn(vs.port, READS)
    finally:
        _stop(master, vs)
    # the store was reloaded, so the second server reads the same needles
    assert wire_aio == wire_thr


@pytest.mark.parametrize("pkg", PACKAGES)
def test_volume_read_needle_extent_contract(tmp_path, pkg):
    """The extent points at exactly the data bytes, the metadata parses,
    and what cannot be zero-copied answers None."""
    vcls, ncls = (JVolume, JNeedle) if pkg == "jax" else (PVolume, PNeedle)
    v = vcls(str(tmp_path), "", 1)
    data = os.urandom(80_000)
    n = ncls(id=0x42, cookie=0x1234, data=data)
    n.name, n.mime = b"hello.bin", b"application/x-test"
    n.set_flag(FLAG_HAS_NAME)
    n.set_flag(FLAG_HAS_MIME)
    v.write_needle(n)
    probe = ncls(id=0x42)
    f, off, count = v.read_needle_extent(probe, min_size=1)
    assert count == len(data)
    f.seek(off)
    assert f.read(count) == data
    f.close()
    assert (probe.name, probe.mime, probe.data, probe.cookie) == (
        b"hello.bin", b"application/x-test", b"", 0x1234)
    assert v.read_needle_extent(ncls(id=0x42), min_size=1 << 20) is None
    v.delete_needle(ncls(id=0x42, cookie=0x1234))
    with pytest.raises(Exception, match="deleted"):
        v.read_needle_extent(ncls(id=0x42))
    with pytest.raises(Exception, match="not found"):
        v.read_needle_extent(ncls(id=0x43))
    v.close()


def test_kill_connection_mid_sendfile_closes_extent_fd(tmp_path, monkeypatch):
    """An aborted client (RST) while a native sendfile is stalled against a
    full TCP window: the .dat extent's fd is still closed."""
    master, vs = _volume_node("port", str(tmp_path / "v"), monkeypatch, mode="aio")
    try:
        data = os.urandom(8 << 20)
        st, _ = p_http.http_bytes("POST", f"http://127.0.0.1:{vs.port}/4,2100000abc", data)
        assert st == 201
        _, files = _spy_sendfile(vs)
        c = socket.socket()
        c.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 32 * 1024)
        c.settimeout(10)
        c.connect(("127.0.0.1", vs.port))
        c.sendall(b"GET /4,2100000abc HTTP/1.1\r\nHost: t\r\nContent-Length: 0\r\n\r\n")
        assert c.recv(1024).startswith(b"HTTP/1.1 200")
        time.sleep(0.3)  # sendfile fills the window and parks
        assert files, "sendfile path not taken"
        assert not files[0].closed
        c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        c.close()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not files[0].closed:
            time.sleep(0.05)
        assert files[0].closed, "extent fd leaked after a mid-transfer abort"
    finally:
        _stop(master, vs)


def test_positional_reads_ignore_a_dups_seeks(tmp_path):
    """A zero-copy reply sendfiles from a dup of the .dat's fd, and
    ``socket.sendfile`` / ``loop.sendfile`` seek the dup when they finish;
    the dup shares the file offset. ``DiskFile.read_at`` reads by position,
    so a seek on a dup in another thread never moves what it reads (a
    seek-then-read, as the JAX package's ``DiskFile`` does, read needles of
    a decoded volume at the wrong place under the cluster read-back)."""
    from seaweedfs_tpu_torch.storage.backend import DiskFile

    data = os.urandom(1 << 20)
    path = str(tmp_path / "1.dat")
    df = DiskFile(path, create=True)
    df.write_at(0, data)
    dup = os.fdopen(os.dup(df.fileno()), "rb", buffering=0)
    stop = threading.Event()

    def seeker():
        i = 0
        while not stop.is_set():
            dup.seek((i * 7919) % len(data))
            i += 1

    t = threading.Thread(target=seeker)
    t.start()
    try:
        wrong = 0
        for i in range(20000):
            off = (i * 4099) % (len(data) - 64)
            wrong += df.read_at(off, 64) != data[off:off + 64]
    finally:
        stop.set()
        t.join()
        dup.close()
        df.close()
    assert wrong == 0
