"""The port's WebDAV gateway (``server/webdav_server.py``) against the JAX
package's.

- Every case of the reference's ``tests/test_webdav.py``, replayed against
  the port's ``WebDavServer`` over a port filer (64 KiB chunks), volume
  server and master (``gateway_pair.replay``).
- One scripted class-2 session (OPTIONS, MKCOL, PUT, PROPFIND, PROPPATCH,
  LOCK and its refresh, PUT with and without the token, GET whole and
  ranged, HEAD, COPY, MOVE, DELETE, UNLOCK) sent to both packages'
  gateways, each over a port filer of its own on one port cluster: the
  replies are equal once ``Date``, ``Last-Modified`` and
  ``X-Sweed-Trace-Id``, the times in bodies (ISO 8601 and RFC 1123) and the
  lock tokens (numbered in order of first appearance) are normalized.
- A tree written through one package's gateway reads back through the
  other's, byte for byte, with its dead properties.
"""

from __future__ import annotations

import http.client
import random
import re

import pytest

from seaweedfs_tpu.server.webdav_server import WebDavServer as JWebDavServer
from seaweedfs_tpu_torch.server.webdav_server import WebDavServer as PWebDavServer

import gateway_pair
from gateway_pair import PORT_FILER, Stack, free_port

REF = gateway_pair.ref_module("test_webdav")
GATEWAY = {"jax": JWebDavServer, "port": PWebDavServer}

UNCOMPARED_HEADERS = {"date", "last-modified", "x-sweed-trace-id"}
_ISO = re.compile(rb"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ")
_RFC1123 = re.compile(rb"[A-Z][a-z]{2}, \d\d [A-Z][a-z]{2} \d{4} \d\d:\d\d:\d\d GMT")
_TOKEN = re.compile(rb"opaquelocktoken:[0-9a-f]{32}")


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    s = Stack("port", tmp_path_factory.mktemp("dav"), chunk_size=64 * 1024)
    s.webdav = PWebDavServer(port=free_port(), filer_url=s.url).start()
    s.extra.append(s.webdav)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def pair(stack):
    """Both packages' gateways, each over a port filer of its own."""
    out = {}
    for kind, cls in GATEWAY.items():
        filer = PORT_FILER(port=free_port(), master_url=stack.master.url,
                           chunk_size=64 * 1024).start()
        out[kind] = cls(port=free_port(), filer_url=filer.url).start()
        stack.extra[:0] = [out[kind], filer]
    return out


@pytest.mark.parametrize("case", gateway_pair.cases(REF))
def test_reference_case(case, stack):
    gateway_pair.replay(REF, case, webdav=stack.webdav)


def _request(url: str, method: str, path: str, body: bytes = b"", headers=None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheaders(), resp.read()
    finally:
        conn.close()


def _normalized(replies: list) -> list:
    tokens: dict[bytes, bytes] = {}

    def fix(b: bytes) -> bytes:
        for t in _TOKEN.findall(b):
            tokens.setdefault(t, b"TOKEN-%d" % len(tokens))
        b = _TOKEN.sub(lambda m: tokens[m.group(0)], b)
        return _RFC1123.sub(b"TIME", _ISO.sub(b"TIME", b))

    out = []
    for status, headers, body in replies:
        hdrs = sorted((k.lower(), fix(v.encode()).decode()) for k, v in headers
                      if k.lower() not in UNCOMPARED_HEADERS)
        out.append((status, hdrs, fix(body)))
    return out


LOCKINFO = REF.LOCKINFO
PROPPATCH = (b'<?xml version="1.0" encoding="utf-8"?>'
             b'<D:propertyupdate xmlns:D="DAV:" xmlns:Z="urn:x-test:">'
             b"<D:set><D:prop><Z:color>indigo</Z:color><Z:size>large</Z:size></D:prop></D:set>"
             b"<D:remove><D:prop><Z:size/></D:prop></D:remove>"
             b"</D:propertyupdate>")


def _session(url: str) -> list:
    rng = random.Random(1414)
    big = rng.randbytes(200_000)  # four 64 KiB chunks
    replies = []

    def go(method, path, body=b"", **headers):
        headers = {k.replace("_", "-"): v for k, v in headers.items()}
        replies.append(_request(url, method, path, body, headers))
        return replies[-1]

    go("OPTIONS", "/")
    go("MKCOL", "/s")
    go("MKCOL", "/s")
    go("MKCOL", "/s/no/parent")
    go("PUT", "/s/a.txt", b"alpha")
    go("PUT", "/s/b.bin", big)
    go("PUT", "/s/a.txt", b"alpha v2")
    go("MKCOL", "/s/sub")
    go("PUT", "/s/sub/c.txt", b"gamma")
    go("PROPFIND", "/s/", Depth="1")
    go("PROPPATCH", "/s/a.txt", PROPPATCH)
    go("PROPFIND", "/s/a.txt", Depth="0")
    _, headers, _ = go("LOCK", "/s/a.txt", LOCKINFO, Timeout="Second-600")
    token = dict(headers)["Lock-Token"].strip("<>")
    go("LOCK", "/s/a.txt", LOCKINFO)
    go("LOCK", "/s/a.txt", b"", If=f"(<{token}>)", Timeout="Second-900")
    go("PUT", "/s/a.txt", b"refused")
    go("PUT", "/s/a.txt", b"alpha v3", If=f"(<{token}>)")
    go("DELETE", "/s/a.txt")
    go("PROPFIND", "/s/a.txt", Depth="0")
    go("GET", "/s/a.txt")
    go("GET", "/s/b.bin", Range="bytes=65000-140000")
    go("HEAD", "/s/b.bin")
    go("COPY", "/s", Destination=f"http://{url}/s2", If=f"(<{token}>)")
    go("MOVE", "/s2/b.bin", Destination=f"http://{url}/s2/moved.bin")
    go("MOVE", "/s2/moved.bin", Destination=f"http://{url}/s2/sub/c.txt", Overwrite="F")
    go("PROPFIND", "/s2/", Depth="1")
    go("GET", "/s2/moved.bin")
    go("LOCK", "/locknull/fresh.txt", LOCKINFO)
    go("UNLOCK", "/s/a.txt", Lock_Token="<opaquelocktoken:bogus>")
    go("UNLOCK", "/s/a.txt", Lock_Token=f"<{token}>")
    go("DELETE", "/s2")
    go("GET", "/s2/moved.bin")
    go("PUT", "/s/a.txt", b"open again")
    return replies


def test_scripted_session_replies_equal(pair):
    got = {kind: _normalized(_session(gw.url)) for kind, gw in pair.items()}
    assert len(got["port"]) == 33
    for i, (j, p) in enumerate(zip(got["jax"], got["port"])):
        assert j == p, i
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_reads_back_through_the_other_gateway(pair, writer):
    """Both gateways over one filer: what one writes, the other reads."""
    reader = "port" if writer == "jax" else "jax"
    w = pair[writer]
    r = GATEWAY[reader](port=free_port(), filer_url=w.client.base.split("//", 1)[1]).start()
    try:
        rng = random.Random(len(writer))
        root = f"/x-{writer}"
        assert _request(w.url, "MKCOL", root)[0] == 201
        files = {f"{root}/f{i}.bin": rng.randbytes(rng.randrange(1, 300_000)) for i in range(6)}
        for p, data in files.items():
            assert _request(w.url, "PUT", p, data)[0] == 201
        assert _request(w.url, "PROPPATCH", f"{root}/f0.bin", PROPPATCH)[0] == 207
        for p, data in files.items():
            assert _request(r.url, "GET", p)[::2] == (200, data), p
        a = _normalized([_request(u, "PROPFIND", f"{root}/", b"", {"Depth": "1"})
                         for u in (w.url, r.url)])
        assert a[0] == a[1] and b"indigo" in a[0][2]
    finally:
        r.stop()
