"""Two S3 gateways, the JAX package's and the port's, over one port cluster,
and the replay of the reference's S3 test cases against both.

A ``Stack`` is one port master and port volume servers (``ec_backend="cpu"``)
with two port filers (``query_backend="cpu"``), each under one gateway:
``apis["jax"]`` is the JAX package's ``S3ApiServer``, ``apis["port"]`` the
port's, with the same identities. The filers are separate so that one case
runs on both gateways from the same state and gives the same replies.

``Stack.replay`` runs a reference test function against one gateway: the
reference module's names of the JAX package's gateway side (``S3ApiServer``,
``IAM``, ``Identity``, ``pp``, ``pe``) are swapped for the port's for the
port's run, while the client side (``S3Client``, the XML helpers) stays the
same, so both gateways see the same requests. Every reply that a client of
the test receives from the gateway's port is recorded (``http.client``'s
``getresponse``, which urllib and both packages' transports go through):
status, headers and body. ``normalized`` drops what differs between two
runs by nature: ``Date``, ``Last-Modified`` and ``X-Sweed-Trace-Id``
headers, ISO timestamps in bodies, and upload ids (numbered in order of
first appearance).
"""

from __future__ import annotations

import functools
import gzip
import http.client
import importlib
import inspect
import io
import os
import re
import socket
import sys
import threading
import time

import pytest

from seaweedfs_tpu.s3api import IAM as JIAM
from seaweedfs_tpu.s3api import Identity as JIdentity
from seaweedfs_tpu.s3api import S3ApiServer as JS3ApiServer
from seaweedfs_tpu_torch.query import select as p_select
from seaweedfs_tpu_torch.s3api import IAM as PIAM
from seaweedfs_tpu_torch.s3api import Identity as PIdentity
from seaweedfs_tpu_torch.s3api import S3ApiServer as PS3ApiServer
from seaweedfs_tpu_torch.s3api import policy_engine as p_pe
from seaweedfs_tpu_torch.s3api import post_policy as p_pp
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

KINDS = ("jax", "port")
TESTS_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(TESTS_DIR)

# the reference modules' gateway-side names, and the port's for them
PORT_NAMES = {"S3ApiServer": PS3ApiServer, "IAM": PIAM, "Identity": PIdentity,
              "pp": p_pp, "pe": p_pe, "sel": p_select}
GATEWAY = {"jax": (JS3ApiServer, JIAM, JIdentity), "port": (PS3ApiServer, PIAM, PIdentity)}

UNCOMPARED_HEADERS = {"date", "last-modified", "x-sweed-trace-id"}
_ISO = re.compile(rb"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(?:\.\d+)?Z")
_UPLOAD_ID = re.compile(rb"<UploadId>([^<]+)</UploadId>")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ref_module(name: str):
    """A reference test module of ``tests/`` (imported as pytest does)."""
    for path in (TESTS_DIR, REPO):  # REPO: `from tests.x import ...` inside cases
        if path not in sys.path:
            sys.path.append(path)
    return importlib.import_module(name)


def cases(module, skip=()) -> list[str]:
    """The module's test functions, in definition order."""
    return [n for n, f in vars(module).items()
            if n.startswith("test_") and callable(f) and n not in skip]


def identities(kind: str, ref_identities) -> list:
    """The reference's identities as ``kind``'s ``Identity`` objects."""
    ident = GATEWAY[kind][2]
    return [ident(i.name, i.access_key, i.secret_key, list(i.actions)) for i in ref_identities]


def stop_jax_server(server) -> None:
    """The JAX package's asyncio server lingers ~10 s on an idle keep-alive
    peer when stopped: stop it beside the rest of the teardown."""
    threading.Thread(target=server.stop, daemon=True).start()


class Stack:
    def __init__(self, tmp, ref_identities=None, chunk_size: int = 0, volumes: int = 1,
                 gateways: bool = True):
        self.master = MasterServer(port=free_port(), node_timeout=60).start()
        self.volumes = [
            VolumeServer([str(tmp / f"v{i}")], port=free_port(), master_url=self.master.url,
                         max_volume_count=20, pulse_seconds=0.5, ec_backend="cpu").start()
            for i in range(volumes)]
        kw = {"chunk_size": chunk_size} if chunk_size else {}
        self.filers = {k: FilerServer(port=free_port(), master_url=self.master.url,
                                      query_backend="cpu", **kw).start() for k in KINDS}
        self.apis = {}
        for k in KINDS if gateways else ():
            server, iam = GATEWAY[k][:2]
            ids = identities(k, ref_identities) if ref_identities is not None else None
            self.apis[k] = server(port=free_port(), filer_url=self.filers[k].url,
                                  iam=iam(ids) if ids is not None else None).start()
        time.sleep(0.6)

    def stop(self) -> None:
        if self.apis:
            stop_jax_server(self.apis["jax"])
            self.apis["port"].stop()
        for f in self.filers.values():
            f.stop()
        for v in self.volumes:
            v.stop()
        self.master.stop()

    def replay(self, module, case: str, kind: str, **fixtures) -> list:
        """Run ``module.case`` against ``kind``'s gateway with the fixtures
        it asks for; returns the normalized replies it received."""
        fn = getattr(module, case)
        params = inspect.signature(fn).parameters
        with pytest.MonkeyPatch.context() as mp:
            # a gzip member carries its mtime: a case that gzips its body
            # would upload different bytes to each gateway across a second
            mp.setattr(gzip, "compress", functools.partial(_GZIP_COMPRESS, mtime=0))
            if kind == "port":
                for name, obj in PORT_NAMES.items():
                    if hasattr(module, name):
                        mp.setattr(module, name, obj)
            with Recorder({self.apis[kind].port} if self.apis else ()) as rec:
                fn(**{n: fixtures[n] for n in params})
        return normalized(rec.replies)


_GZIP_COMPRESS = gzip.compress


class Recorder:
    """Records every reply read from a connection to one of ``ports``."""

    def __init__(self, ports):
        self.ports = set(ports)
        self.replies: list = []
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self) -> "Recorder":
        orig = self._orig = http.client.HTTPConnection.getresponse
        rec = self

        def getresponse(conn, *a, **k):
            resp = orig(conn, *a, **k)
            if conn.port in rec.ports:
                data = resp.read()
                with rec._lock:
                    rec.replies.append((resp.status, resp.getheaders(), data))
                if data:  # hand the body back to the caller
                    resp.fp = io.BufferedReader(io.BytesIO(data))
                    resp.length = len(data)
                    resp.chunked = False
            return resp

        http.client.HTTPConnection.getresponse = getresponse
        return self

    def __exit__(self, *exc) -> None:
        http.client.HTTPConnection.getresponse = self._orig


def normalized(replies: list) -> list:
    ids: dict[bytes, bytes] = {}
    for _, _, body in replies:
        for uid in _UPLOAD_ID.findall(body):
            ids.setdefault(uid, b"UPLOAD-%d" % len(ids))
    out = []
    for status, headers, body in replies:
        body = _ISO.sub(b"TIME", body)
        for uid, name in ids.items():
            body = body.replace(uid, name)
        hdrs = [(k, v) for k, v in headers if k.lower() not in UNCOMPARED_HEADERS]
        out.append((status, hdrs, body))
    return out
