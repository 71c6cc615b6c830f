"""The port's S3 gateway against the JAX package's, over one port cluster.

Every case of the reference's ``tests/test_s3api.py`` and
``tests/test_s3_fuzz.py`` runs on both gateways (``s3_pair.Stack``: each
gateway over its own port filer of one port master and volume server), with
the reference's own assertions, and the replies each run received must be
equal: status, headers and body bytes, with only ``Date``,
``Last-Modified``, ``X-Sweed-Trace-Id``, timestamps and upload ids left out.
The reference's one case that calls the auth module directly runs on each
package's. Then interchange: objects and multipart uploads written through
one gateway read back equal through the other, over one filer.
"""

import hashlib
from datetime import datetime, timedelta, timezone

import pytest

import seaweedfs_tpu.s3api.auth as j_auth
import seaweedfs_tpu_torch.s3api.auth as p_auth
from seaweedfs_tpu.s3api import S3ApiServer as JS3ApiServer
from seaweedfs_tpu.s3api.s3_client import S3Client as JS3Client
from seaweedfs_tpu_torch.s3api import S3ApiServer as PS3ApiServer
from seaweedfs_tpu_torch.s3api.s3_client import S3Client as PS3Client

import s3_pair
from s3_pair import KINDS, Stack, free_port, stop_jax_server

ref = s3_pair.ref_module("test_s3api")
ref_fuzz = s3_pair.ref_module("test_s3_fuzz")
AUTH = {"jax": j_auth, "port": p_auth}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    st = Stack(tmp_path_factory.mktemp("s3api"), ref.IDENTITIES, chunk_size=64 * 1024)
    yield st
    st.stop()


@pytest.fixture(scope="module")
def fuzz_stack(tmp_path_factory):
    st = Stack(tmp_path_factory.mktemp("s3fuzz"),
               [ref.Identity("admin", "AK", "SK", ["Admin"])], chunk_size=64 * 1024)
    yield st
    st.stop()


@pytest.mark.parametrize("case", s3_pair.cases(ref, skip=("test_presigned_future_dated_rejected",)))
def test_reference_case(case, stack):
    got = {}
    for kind in KINDS:
        api = stack.apis[kind]
        client = ref.S3Client(f"http://{api.url}", "AKIAADMIN", "adminsecret")
        got[kind] = stack.replay(ref, case, kind, s3=api, client=client)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("case", s3_pair.cases(ref_fuzz, skip=("test_raw_socket_garbage",)))
def test_reference_fuzz_case(case, fuzz_stack):
    got = {kind: fuzz_stack.replay(ref_fuzz, case, kind, stack=fuzz_stack.apis[kind])
           for kind in KINDS}
    assert got["port"] == got["jax"]
    assert len(got["port"]) > 300  # every fuzzed request reached the gateway


def test_reference_raw_socket_garbage(fuzz_stack):
    """The reference's raw-socket case on the port's gateway alone, over a
    filer of its own: its replies never reach http.client to be compared
    (the reference runs it on the JAX package's gateway)."""
    from seaweedfs_tpu_torch.server.filer_server import FilerServer

    filer = FilerServer(port=free_port(), master_url=fuzz_stack.master.url,
                        query_backend="cpu").start()
    api = PS3ApiServer(port=free_port(), filer_url=filer.url,
                       iam=s3_pair.PIAM(s3_pair.identities("port", [ref.Identity(
                           "admin", "AK", "SK", ["Admin"])]))).start()
    try:
        ref_fuzz.test_raw_socket_garbage(api)
    finally:
        api.stop()
        filer.stop()


@pytest.mark.parametrize("kind", KINDS)
def test_presigned_future_dated_rejected(kind):
    """The reference's case on each package's auth module: a URL signed
    hours ahead is refused (15 minutes of forward skew at most)."""
    auth = AUTH[kind]
    iam = auth.IAM([auth.Identity("u", "AK", "SK", ["Admin"])])
    headers = {"Host": "example"}

    def presigned_query(when):
        amz_date = when.strftime("%Y%m%dT%H%M%SZ")
        scope = f"{amz_date[:8]}/us-east-1/s3/aws4_request"
        query = {"X-Amz-Algorithm": "AWS4-HMAC-SHA256", "X-Amz-Credential": f"AK/{scope}",
                 "X-Amz-Date": amz_date, "X-Amz-Expires": "3600",
                 "X-Amz-SignedHeaders": "host"}
        query["X-Amz-Signature"] = iam._v4_signature(
            "SK", "GET", "/b/k", query, headers, ["host"], auth.UNSIGNED_PAYLOAD,
            amz_date, scope, skip_q=("X-Amz-Signature",))
        return query

    ident, err = iam.authenticate("GET", "/b/k", presigned_query(datetime.now(timezone.utc)),
                                  headers, b"")
    assert err is None and ident is not None
    ident, err = iam.authenticate(
        "GET", "/b/k", presigned_query(datetime.now(timezone.utc) + timedelta(hours=2)),
        headers, b"")
    assert err == auth.ERR_REQUEST_NOT_READY and ident is None


class _FrozenDatetime(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2026, 3, 1, 12, 0, 0, tzinfo=tz)


def test_clients_sign_fixed_requests_alike(stack, monkeypatch):
    """On the same clock both packages' clients sign byte for byte alike:
    header, presigned and streaming (aws-chunked) signatures, whatever the
    order of the query's keys."""
    import seaweedfs_tpu.s3api.s3_client as j_mod
    import seaweedfs_tpu_torch.s3api.s3_client as p_mod

    monkeypatch.setattr(j_mod, "datetime", _FrozenDatetime)
    monkeypatch.setattr(p_mod, "datetime", _FrozenDatetime)
    j = JS3Client("http://127.0.0.1:1", "AKIAADMIN", "adminsecret")
    p = PS3Client("http://127.0.0.1:1", "AKIAADMIN", "adminsecret")
    query = {"prefix": "a b", "list-type": "2", "max-keys": "7", "delimiter": "/"}
    assert (p._sign("GET", "/bk", dict(query), {}, b"")
            == j._sign("GET", "/bk", dict(reversed(query.items())), {}, b""))
    assert p.presign("GET", "/bk/k ey", expires=600) == j.presign("GET", "/bk/k ey", expires=600)
    sent = {}
    monkeypatch.setattr(p, "_send", lambda m, url, body, h: sent.update(p=(url, body, h)) or (200, b"", {}))
    p.put_object_streaming("bk", "k", [b"a" * 70000, b"b" * 10])
    assert sent["p"][1].count(b";chunk-signature=") == 3


def test_fixed_signed_requests_get_equal_replies(stack, monkeypatch):
    """Requests signed once, on a fixed clock, get equal replies from both
    gateways: a listing, and the same request with a signature one digit
    off (403 SignatureDoesNotMatch)."""
    import seaweedfs_tpu.s3api.s3_client as j_mod

    monkeypatch.setattr(j_mod, "datetime", _FrozenDatetime)
    replies = {}
    for kind in KINDS:
        c = JS3Client(f"http://{stack.apis[kind].url}", "AKIAADMIN", "adminsecret")
        good = c._sign("GET", "/", {"x-id": "ListBuckets"}, {}, b"")
        bad = dict(good, Authorization=good["Authorization"][:-1]
                   + ("0" if good["Authorization"][-1] != "0" else "1"))
        with s3_pair.Recorder({stack.apis[kind].port}) as rec:
            for h in (good, bad):
                JS3Client(f"http://{stack.apis[kind].url}").request(
                    "GET", "/", query={"x-id": "ListBuckets"}, headers=dict(h))
        replies[kind] = s3_pair.normalized(rec.replies)
    assert replies["port"] == replies["jax"]
    assert [r[0] for r in replies["port"]] == [200, 403]
    assert b"SignatureDoesNotMatch" in replies["port"][1][2]


@pytest.fixture(scope="module")
def shared(stack):
    """Both packages' gateways over the port filer of ``stack.apis["port"]``."""
    filer = stack.filers["port"].url
    iam_j = ref.IAM(ref.IDENTITIES)
    iam_p = s3_pair.PIAM(s3_pair.identities("port", ref.IDENTITIES))
    apis = {"jax": JS3ApiServer(port=free_port(), filer_url=filer, iam=iam_j).start(),
            "port": PS3ApiServer(port=free_port(), filer_url=filer, iam=iam_p).start()}
    yield {k: JS3Client(f"http://{a.url}", "AKIAADMIN", "adminsecret") for k, a in apis.items()}
    stop_jax_server(apis["jax"])
    apis["port"].stop()


@pytest.mark.parametrize("writer", KINDS)
def test_interchange(shared, writer):
    """An object, a streamed object and a multipart upload written through
    one package's gateway read back equal, with the same ETag and listing,
    through the other's."""
    reader = "port" if writer == "jax" else "jax"
    w, r = shared[writer], shared[reader]
    bucket = f"xchg-{writer}"
    assert w.create_bucket(bucket)[0] == 200
    small = hashlib.sha256(writer.encode()).digest() * 100
    assert w.put_object(bucket, "small.bin", small, **{"X-Amz-Meta-Src": writer})[0] == 200
    streamed = [bytes([i]) * 100_000 for i in range(3)]
    assert w.put_object_streaming(bucket, "streamed.bin", streamed)[0] == 200
    uid = w.initiate_multipart(bucket, "multi.bin")
    parts = [bytes([65 + i]) * (5 << 20 if i < 2 else 1000) for i in range(3)]
    etags = [(i + 1, w.upload_part(bucket, "multi.bin", uid, i + 1, p)) for i, p in enumerate(parts)]
    status, body, _ = w.complete_multipart(bucket, "multi.bin", uid, etags)
    assert status == 200, body
    for key, data in (("small.bin", small), ("streamed.bin", b"".join(streamed)),
                      ("multi.bin", b"".join(parts))):
        ws, wd, wh = w.get_object(bucket, key)
        rs, rd, rh = r.get_object(bucket, key)
        assert (rs, rd) == (ws, wd) == (200, data), key
        assert rh["ETag"] == wh["ETag"]
    assert r.head_object(bucket, "small.bin")[2].get("X-Amz-Meta-Src") == writer
    assert r.get_object(bucket, "multi.bin", rng="bytes=5242870-5242889")[1] == \
        b"A" * 10 + b"B" * 10
    lw = w.list_objects(bucket, v2=True)
    lr = r.list_objects(bucket, v2=True)
    assert lr[:2] == lw[:2] and lr[0] == 200


def _raw_replies(port, requests):
    """Send ``requests`` (raw bytes) on one keep-alive socket; each reply's
    raw bytes, with the Date, Last-Modified and trace-id lines dropped."""
    import socket

    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        for req in requests:
            s.sendall(req)
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += s.recv(65536)
            head, _, body = buf.partition(b"\r\n\r\n")
            lines = head.split(b"\r\n")
            clen = next(int(v.split(b":")[1]) for v in lines
                        if v.lower().startswith(b"content-length:"))
            while len(body) < clen:
                body += s.recv(65536)
            keep = [v for v in lines if not v.lower().startswith(
                (b"date:", b"last-modified:", b"x-sweed-trace-id:"))]
            out.append(b"\r\n".join(keep) + b"\r\n\r\n" + body)
    return out


def test_native_get_frames_like_the_bridged_path(stack, monkeypatch):
    """The asyncio core serves a signed GetObject natively on the loop
    (``_get_object_native`` over ``aio_transport.stream``); its replies,
    whole and ranged, on one keep-alive connection, are byte for byte the
    bridged handler's (the threads core) and the JAX package's gateway's."""
    import seaweedfs_tpu_torch.server.http_util as p_http

    blob = bytes(range(256)) * 4000
    filer = stack.filers["port"].url
    replies = {}
    for name, server, mode in (("port-aio", PS3ApiServer, "aio"),
                               ("port-threads", PS3ApiServer, "threads"),
                               ("jax-aio", JS3ApiServer, "aio")):
        monkeypatch.setenv("SWEED_SERVING", mode)
        iam = (ref.IAM(ref.IDENTITIES) if server is JS3ApiServer
               else s3_pair.PIAM(s3_pair.identities("port", ref.IDENTITIES)))
        api = server(port=free_port(), filer_url=filer, iam=iam).start()
        monkeypatch.delenv("SWEED_SERVING")
        try:
            c = JS3Client(f"http://{api.url}", "AKIAADMIN", "adminsecret")
            if name == "port-aio":
                c.create_bucket("native")
                c.put_object("native", "blob.bin", blob, **{"X-Amz-Meta-K": "v"})
            reqs = []
            for rng in ("", "", "bytes=1000-70999"):
                h = c._sign("GET", "/native/blob.bin", {}, {"Range": rng} if rng else {}, b"")
                reqs.append(b"GET /native/blob.bin HTTP/1.1\r\n" + b"".join(
                    f"{k}: {v}\r\n".encode() for k, v in h.items()) + b"\r\n")
            before = p_http.SERVING.snapshot()["native_hits"]
            replies[name] = _raw_replies(api.port, reqs)
            if name == "port-aio":  # the 2nd and 3rd GETs ran on the loop
                assert p_http.SERVING.snapshot()["native_hits"] - before >= 2
        finally:
            stop_jax_server(api) if server is JS3ApiServer else api.stop()
    assert replies["port-aio"] == replies["port-threads"] == replies["jax-aio"]
    assert replies["port-aio"][0].endswith(blob)
    assert b" 206 " in replies["port-aio"][2].split(b"\r\n")[0]
    assert replies["port-aio"][2].endswith(blob[1000:71000])
