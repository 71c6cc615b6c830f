"""Fixtures shared by the serving-stack tests: one JAX and one port cluster
side by side, wire-level request helpers, and a timestamp-masked view of a
volume's files.

Each cluster is a master and one volume server on the JAX package's
defaults (the native engine on the public port, the asyncio core behind
it). ``VID`` is allocated on both through ``/admin/assign_volume``, so the
same fids address the same needle keys in both, whatever the masters'
sequences do.
"""

from __future__ import annotations

import contextlib
import http.client
import socket
import threading
import time

from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu_torch.server.http_util import http_bytes
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.storage.needle import get_actual_size, parse_needle_header
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
from seaweedfs_tpu_torch.storage.types import NEEDLE_HEADER_SIZE

VID = 3
KINDS = ("jax", "port")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Node:
    """One cluster: ``master``, ``vs`` (its volume server), ``url`` (the
    public host:port), ``dir`` (the volume directory)."""

    def __init__(self, kind, master, vs, directory):
        self.kind, self.master, self.vs, self.dir = kind, master, vs, directory
        self.url = f"127.0.0.1:{vs.port}"


def start_node(kind: str, directory: str, **vs_kwargs) -> Node:
    mcls, vcls, backend = ((JMasterServer, JVolumeServer, "numpy") if kind == "jax"
                           else (PMasterServer, PVolumeServer, "cpu"))
    mkw = {k: vs_kwargs.pop(k) for k in ("jwt_signing_key",) if k in vs_kwargs}
    master = mcls(port=free_port(), node_timeout=60, **mkw).start()
    vs = vcls([directory], port=free_port(), master_url=master.url, pulse_seconds=0.5,
              ec_backend=backend, **(mkw | vs_kwargs)).start()
    return Node(kind, master, vs, directory)


def stop_node(node: Node) -> None:
    node.vs.stop()
    if node.kind == "port":
        node.master.stop()
    else:  # the JAX master's stop waits ~10 s on its loop: beside the next test
        threading.Thread(target=node.master.stop, daemon=True).start()


@contextlib.contextmanager
def pair(tmp_path_factory, assign_vid: bool = True, **vs_kwargs):
    """{"jax": Node, "port": Node}, each with volume VID allocated."""
    nodes = {}
    try:
        for kind in KINDS:
            nodes[kind] = start_node(kind, str(tmp_path_factory.mktemp(kind)),
                                     **dict(vs_kwargs))
            if assign_vid:
                st, body = http_bytes(
                    "POST", f"http://{nodes[kind].url}/admin/assign_volume?volume={VID}")
                assert st == 200, (kind, st, body)
        yield nodes
    finally:
        for node in nodes.values():
            stop_node(node)


# headers that differ between two servers by nature: the time, and the
# trace id (a random id per request)
UNCOMPARED = (b"date:", b"x-sweed-trace-id:")


def request(url: str, method: str, path: str, body: bytes = None, headers=None):
    """One request on a fresh connection -> (status, headers without those
    in UNCOMPARED, body). Header names keep their case and order."""
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=20)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        hdrs = [(k, v) for k, v in r.getheaders()
                if (k.lower() + ":").encode() not in UNCOMPARED]
        return r.status, hdrs, r.read()
    finally:
        conn.close()


def both(nodes, method: str, path: str, body: bytes = None, headers=None) -> dict:
    return {k: request(n.url, method, path, body, headers) for k, n in nodes.items()}


def raw_exchange(port: int, payload: bytes, read_timeout: float = 0.5,
                 first_byte_timeout: float = 0.6) -> bytes:
    """Send raw bytes, read what comes back until the peer closes or
    ``read_timeout`` passes quietly (``first_byte_timeout`` for the first
    bytes, so a reply a loaded machine is slow to start is still read
    whole)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        try:
            s.sendall(payload)
        except OSError:
            pass  # the peer may close before taking it all
        s.settimeout(first_byte_timeout)
        out = b""
        try:
            while len(out) < 1 << 20:
                chunk = s.recv(65536)
                if not chunk:
                    break
                out += chunk
                s.settimeout(read_timeout)
        except (socket.timeout, ConnectionResetError):
            pass
        return out
    finally:
        s.close()


def strip_dates(raw: bytes) -> bytes:
    """A raw response stream without the header lines in UNCOMPARED."""
    return b"".join(line for line in raw.splitlines(keepends=True)
                    if not line.lower().startswith(UNCOMPARED))


def masked_dat(path: str, version: int = 3) -> bytes:
    """The .dat's bytes with each record's timestamps zeroed: the 8-byte
    append time (v3) and, when the flags say so, the 5-byte last-modified
    seconds. Everything else (layout, offsets, data, flags, CRCs, padding)
    stays."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    extra = int.from_bytes(raw[6:8], "big")
    off = SUPER_BLOCK_SIZE + extra
    while off + NEEDLE_HEADER_SIZE <= len(raw):
        _, _, size = parse_needle_header(bytes(raw[off:off + NEEDLE_HEADER_SIZE]))
        total = get_actual_size(max(size, 0), version)
        body = off + NEEDLE_HEADER_SIZE
        if size > 0:
            dlen = int.from_bytes(raw[body:body + 4], "big")
            p = body + 4 + dlen
            flags = raw[p]
            p += 1
            if flags & 0x02:  # name
                p += 1 + raw[p]
            if flags & 0x04:  # mime
                p += 1 + raw[p]
            if flags & 0x08:  # last modified, 5 bytes
                raw[p:p + 5] = bytes(5)
        ts = body + max(size, 0) + 4
        if version == 3:
            raw[ts:ts + 8] = bytes(8)
        off += total
    return bytes(raw)


def wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()
