"""The port's fid-scoped JWT and IP whitelist against the JAX package's, and
the port volume server's write, read and delete handlers enforcing them."""

import socket
import threading

import pytest

from seaweedfs_tpu.security import Guard as JGuard
from seaweedfs_tpu.security import gen_jwt as jgen_jwt
from seaweedfs_tpu.security import verify_fid_jwt as jverify
from seaweedfs_tpu.server.http_util import http_bytes
from seaweedfs_tpu.server.master_server import MasterServer
from seaweedfs_tpu_torch.security import Guard as PGuard
from seaweedfs_tpu_torch.security import gen_jwt as pgen_jwt
from seaweedfs_tpu_torch.security import verify_fid_jwt as pverify
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

FID = "3,01637037d6"


@pytest.mark.parametrize("signer,verifier", [(jgen_jwt, pverify), (pgen_jwt, jverify),
                                             (pgen_jwt, pverify)])
def test_tokens_cross_verify(signer, verifier):
    tok = signer("key", FID)
    assert verifier("key", tok, FID)
    assert verifier("key", tok, FID.replace(",", "/"))
    assert not verifier("other", tok, FID)
    assert not verifier("key", tok, "3,01637037d7")
    assert not verifier("key", signer("key", FID, expires_seconds=-5), FID)
    assert not verifier("key", "not.a.token", FID)


@pytest.mark.parametrize("whitelist", [None, [], ["*"], ["10.0.0.1"], ["10.0.0.0/8", "::1"],
                                       ["192.168.1.0/24", "127.0.0.1"]])
def test_guard_matches_reference(whitelist):
    p, j = PGuard(whitelist), JGuard(whitelist)
    for ip in ("127.0.0.1", "10.1.2.3", "10.0.0.1", "192.168.1.9", "::1", "garbage"):
        assert p.allowed(ip) == j.allowed(ip), (whitelist, ip)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def master():
    m = MasterServer(port=free_port(), node_timeout=60).start()
    yield m
    threading.Thread(target=m.stop, daemon=True).start()  # its stop takes ~10 s


def _server(tmp_path, master, **kw):
    vs = VolumeServer([str(tmp_path)], port=free_port(), master_url=master.url,
                      pulse_seconds=0.5, ec_backend="cpu", **kw).start()
    http_bytes("POST", f"http://127.0.0.1:{vs.port}/admin/assign_volume?volume=3")
    return vs, f"http://127.0.0.1:{vs.port}"


def test_handlers_check_the_fid_token(tmp_path, master):
    vs, url = _server(tmp_path, master, jwt_signing_key="wk", jwt_read_key="rk")
    try:
        assert http_bytes("POST", f"{url}/{FID}", b"data")[0] == 401
        assert http_bytes("POST", f"{url}/{FID}?auth={pgen_jwt('wk', '3,01637037d7')}",
                          b"data")[0] == 401
        assert http_bytes("POST", f"{url}/{FID}?auth={pgen_jwt('wk', FID)}", b"data")[0] == 201
        assert http_bytes("GET", f"{url}/{FID}")[0] == 401
        assert http_bytes("GET", f"{url}/{FID}?auth={pgen_jwt('wk', FID)}")[0] == 401
        assert http_bytes("GET", f"{url}/{FID}",
                          headers={"Authorization": f"Bearer {pgen_jwt('rk', FID)}"}) == (200, b"data")
        assert http_bytes("DELETE", f"{url}/{FID}")[0] == 401
        assert http_bytes("DELETE", f"{url}/{FID}?auth={jgen_jwt('wk', FID)}")[0] == 202
        assert http_bytes("GET", f"{url}/{FID}?auth={pgen_jwt('rk', FID)}")[0] == 404
    finally:
        vs.stop()


def test_whitelist_refuses_other_addresses(tmp_path, master):
    vs, url = _server(tmp_path, master, whitelist=["10.0.0.1"])
    try:
        for method, body in (("POST", b"x"), ("GET", None), ("DELETE", None)):
            assert http_bytes(method, f"{url}/{FID}", body)[0] == 403, method
    finally:
        vs.stop()
