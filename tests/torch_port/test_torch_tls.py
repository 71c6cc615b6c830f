"""TLS termination and mutual TLS on the port's S3 gateway, against the JAX
package's.

The cases of the reference's ``tests/test_tls.py``: certificates are minted
per run with the openssl CLI (the tests skip when it is missing). Both
gateways (``s3_pair.Stack``, each over its own port filer) serve https with
their own package's ``security/tls.py`` contexts, in both serving cores, and
the same client requests get the same statuses and bodies from both.
"""

import shutil
import socket
import ssl
import subprocess
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

import seaweedfs_tpu.security.tls as j_tls
import seaweedfs_tpu_torch.security.tls as p_tls
from seaweedfs_tpu_torch.s3api import IAM, Identity, S3ApiServer
from seaweedfs_tpu_torch.s3api.s3_client import S3Client
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

import s3_pair
from s3_pair import GATEWAY, KINDS, free_port, stop_jax_server

TLS = {"jax": j_tls, "port": p_tls}


def _openssl(*args):
    subprocess.run(["openssl", *args], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A CA, a server pair (SAN 127.0.0.1) and a client pair it signed, and
    a rogue self-signed client certificate."""
    if shutil.which("openssl") is None:
        pytest.skip("the openssl CLI mints the certificates and is not installed")
    d = tmp_path_factory.mktemp("certs")
    ca_key, ca = str(d / "ca.key"), str(d / "ca.crt")
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", ca_key,
             "-out", ca, "-days", "2", "-subj", "/CN=weed-test-ca")
    out = {"ca": ca}
    for name, cn, ext in (("server", "127.0.0.1", "subjectAltName=IP:127.0.0.1"),
                          ("client", "ops-client", None)):
        key, csr, crt = (str(d / f"{name}.{e}") for e in ("key", "csr", "crt"))
        _openssl("req", "-newkey", "rsa:2048", "-nodes", "-keyout", key, "-out", csr,
                 "-subj", f"/CN={cn}")
        sign = ["x509", "-req", "-in", csr, "-CA", ca, "-CAkey", ca_key,
                "-CAcreateserial", "-out", crt, "-days", "2"]
        if ext:
            ext_file = str(d / f"{name}.ext")
            with open(ext_file, "w") as f:
                f.write(ext + "\n")
            sign += ["-extfile", ext_file]
        _openssl(*sign)
        out[f"{name}_key"], out[f"{name}_crt"] = key, crt
    out["rogue_key"], out["rogue_crt"] = str(d / "rogue.key"), str(d / "rogue.crt")
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", out["rogue_key"],
             "-out", out["rogue_crt"], "-days", "2", "-subj", "/CN=rogue")
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    st = s3_pair.Stack.__new__(s3_pair.Stack)
    tmp = tmp_path_factory.mktemp("tls")
    st.master = MasterServer(port=free_port(), node_timeout=60).start()
    st.volumes = [VolumeServer([str(tmp / "v")], port=free_port(), master_url=st.master.url,
                               max_volume_count=10, pulse_seconds=0.5,
                               ec_backend="cpu").start()]
    st.filers = {k: FilerServer(port=free_port(), master_url=st.master.url,
                                query_backend="cpu").start() for k in KINDS}
    yield st
    for f in st.filers.values():
        f.stop()
    st.volumes[0].stop()
    st.master.stop()


def _gateway(kind, cluster, certs, ca=True, iam=True):
    server, iam_cls, ident = GATEWAY[kind]
    return server(port=free_port(), filer_url=cluster.filers[kind].url,
                  iam=iam_cls([ident("u", "AK", "SK", ["Admin", "Read", "Write", "List"])])
                  if iam else None,
                  tls_cert=certs["server_crt"], tls_key=certs["server_key"],
                  tls_ca=certs["ca"] if ca else "").start()


def _stop(kind, api):
    stop_jax_server(api) if kind == "jax" else api.stop()


@pytest.fixture(scope="module", params=["aio", "threads"])
def mtls(request, cluster, certs):
    """Both gateways with mutual TLS, in one serving core."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SWEED_SERVING", request.param)
    apis = {k: _gateway(k, cluster, certs) for k in KINDS}
    mp.undo()
    time.sleep(0.3)
    yield apis
    for k, api in apis.items():
        _stop(k, api)


def test_mtls_client_cert_accepted(mtls, certs):
    got = {}
    bucket = f"secure{mtls['port'].port}"  # one per serving core
    for kind in KINDS:
        ctx = TLS[kind].client_context(certs["ca"], certs["client_crt"], certs["client_key"])
        c = S3Client(f"https://127.0.0.1:{mtls[kind].port}", "AK", "SK", ssl_context=ctx)
        status, body, _ = c.create_bucket(bucket)
        assert status in (200, 201), body
        put = c.put_object(bucket, "x.bin", b"over mtls")
        get = c.get_object(bucket, "x.bin")
        got[kind] = [(status, body), put[:2], get[:2]]
        assert put[0] == 200 and get[:2] == (200, b"over mtls")
    assert got["port"] == got["jax"]


def test_mtls_rejects_missing_or_rogue_client_cert(mtls, certs):
    for kind in KINDS:
        url = f"https://127.0.0.1:{mtls[kind].port}/"
        for ctx in (TLS[kind].client_context(certs["ca"]),  # no client certificate
                    TLS[kind].client_context(certs["ca"], certs["rogue_crt"],
                                             certs["rogue_key"])):  # not from the CA
            with pytest.raises((ssl.SSLError, urllib.error.URLError, OSError)):
                urllib.request.urlopen(url, context=ctx, timeout=5)


def test_stalled_client_does_not_block_server(mtls, certs):
    """A TCP client that never speaks TLS freezes no accept loop: the
    handshakes run per connection, under a deadline."""
    for kind in KINDS:
        stall = socket.create_connection(("127.0.0.1", mtls[kind].port))
        try:
            ctx = TLS[kind].client_context(certs["ca"], certs["client_crt"], certs["client_key"])
            c = S3Client(f"https://127.0.0.1:{mtls[kind].port}", "AK", "SK", ssl_context=ctx)
            t0 = time.monotonic()
            status, _, _ = c.request("GET", "/")
            assert status == 200 and time.monotonic() - t0 < 5
        finally:
            stall.close()


@pytest.mark.parametrize("kind", KINDS)
def test_client_verifies_server_against_ca(kind, certs):
    """A client pinning the CA refuses a server whose certificate the CA did
    not sign."""
    rogue_ctx = TLS[kind].server_context(certs["rogue_crt"], certs["rogue_key"])

    class _H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

    srv = HTTPServer(("127.0.0.1", 0), _H)
    srv.socket = rogue_ctx.wrap_socket(srv.socket, server_side=True)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ctx = TLS[kind].client_context(certs["ca"], certs["client_crt"], certs["client_key"])
        ctx.check_hostname = False  # the chain check alone
        with pytest.raises((ssl.SSLError, urllib.error.URLError)):
            urllib.request.urlopen(f"https://127.0.0.1:{srv.server_address[1]}/",
                                   context=ctx, timeout=5)
    finally:
        srv.shutdown()


@pytest.mark.parametrize("kind", KINDS)
def test_tls_misconfig_and_combined_pem(kind, certs, tmp_path):
    tls = TLS[kind]
    # a key or CA without a certificate refuses to start rather than serve plaintext
    with pytest.raises(ValueError, match="cert.file"):
        tls.optional_server_context("", "", certs["ca"])
    with pytest.raises(ValueError, match="cert.file"):
        tls.optional_server_context("", certs["server_key"], "")
    assert tls.optional_server_context("", "", "") is None
    combined = tmp_path / "combined.pem"
    combined.write_bytes(open(certs["server_crt"], "rb").read()
                         + open(certs["server_key"], "rb").read())
    assert tls.optional_server_context(str(combined)) is not None
    # a client without a CA keeps the system's verification unless insecure
    assert tls.client_context().verify_mode == ssl.CERT_REQUIRED
    assert tls.client_context(insecure=True).verify_mode == ssl.CERT_NONE


@pytest.mark.parametrize("mode", ["aio", "threads"])
def test_stopped_tls_server_severs_keepalive_and_plain_https(mode, cluster, certs, monkeypatch):
    """A certificate without a CA is ordinary https; stop() returns at once
    beside a live keep-alive TLS connection, which is dead after it (no
    ghost answers)."""
    monkeypatch.setenv("SWEED_SERVING", mode)
    api = S3ApiServer(port=free_port(), filer_url=cluster.filers["port"].url,
                      iam=IAM([Identity("u", "AK", "SK", ["Admin"])]),
                      tls_cert=certs["server_crt"], tls_key=certs["server_key"]).start()
    time.sleep(0.2)
    ctx = p_tls.client_context(certs["ca"])  # the CA pinned, no client certificate
    c = S3Client(f"https://127.0.0.1:{api.port}", "AK", "SK", ssl_context=ctx)
    assert c.create_bucket(f"plain-tls-{mode}")[0] == 200
    ctx.check_hostname = False
    tls = ctx.wrap_socket(socket.create_connection(("127.0.0.1", api.port), timeout=10))
    tls.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += tls.recv(65536)
    head, _, rest = buf.partition(b"\r\n\r\n")
    clen = next(int(line.split(b":")[1]) for line in head.split(b"\r\n")
                if line.lower().startswith(b"content-length:"))
    while len(rest) < clen:
        rest += tls.recv(65536)
    assert head.startswith(b"HTTP/1.1")
    t0 = time.monotonic()
    api.stop()
    # the live TLS connection holds no stop for its close_notify
    assert time.monotonic() - t0 < 5
    time.sleep(0.3)
    try:
        tls.settimeout(5)
        tls.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
        ghost = tls.recv(65536)
    except (OSError, ssl.SSLError):
        ghost = b""
    assert ghost == b"", f"stopped server still answered: {ghost[:60]!r}"
    tls.close()
