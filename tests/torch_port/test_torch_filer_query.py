"""``POST /_query`` and ``POST /_select`` through the port's filer, held
against the JAX package's filer over the same port cluster.

A port master and two port volume servers (``ec_backend="cpu"``) serve
both filers (1 MiB chunks). Each filer holds the same CSV objects: three
single-chunk ones (the data-local pushdown: the volume server holding the
needle scans it), a 2.5 MiB three-chunk one and a cipher'd single-chunk
one (both scanned filer-side), and a gzip'd copy for ``/_select``. The
port filer scans on ``query_backend="cpu"``; the JAX filer on its
``numpy`` backend.

- Every query kind of the chip check's phase 7 gets the same reply from
  both filers, equal to the port's scan of the whole object.
- The pushdown provably engaged: the volume servers' own scan counts grow
  by one per single-chunk query, and the port filer's routing counters
  split pushdown and filer-side as sent.
- ``/_select`` event streams are byte-equal between the filers, and their
  CRCs hold.
- A port filer on the default backend, with no card, answers a filer-side
  query and a ``/_select`` with a 500 naming the device, and never scans on
  the CPU; its single-chunk queries still run on the volume server.
"""

import gzip
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu_torch.query import execute_request
from seaweedfs_tpu_torch.query import select as psel
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PFilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.stats.metrics import QUERY_COUNTERS

CHUNK = 1 << 20
QUERIES = [
    ("probe", {"select": ["id", "name"], "where": {"and": [
        {"field": "region", "op": "=", "value": "east"},
        {"field": "score", "op": ">", "value": 995}]}}),
    ("contains", {"sql": "SELECT * FROM s3object WHERE name LIKE '%r00012%'"}),
    ("starts_with", {"sql": "SELECT id, name FROM s3object WHERE name LIKE 'r00001%'"}),
    ("lex_lt", {"select": ["id", "name"],
                "where": {"field": "name", "op": "<", "value": "r0000100"}}),
    ("not_or", {"sql": "SELECT id FROM s3object WHERE NOT region = 'west' OR score <= 3.5"}),
    ("limit", {"sql": "SELECT * FROM s3object LIMIT 10"}),
]
SELECT_XML = (b"<SelectObjectContentRequest><Expression>SELECT * FROM s3object WHERE "
              b"region = 'east' AND score &gt; 995</Expression><ExpressionType>SQL"
              b"</ExpressionType><InputSerialization><CompressionType>%s</CompressionType>"
              b"<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV></InputSerialization>"
              b"<OutputSerialization><JSON/></OutputSerialization>"
              b"</SelectObjectContentRequest>")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def csv_object(seed: int, size: int) -> bytes:
    """The query probe's schema ``id,region,score,name``, whole rows under
    ``size`` bytes."""
    rng = np.random.default_rng(seed)
    n = size // 24
    reg = np.array(["east", "west", "north", "south"])[rng.integers(0, 4, n)]
    cents = rng.integers(0, 100_000, n)
    names = rng.integers(0, 10 ** 7, n)
    data = ("id,region,score,name\n" + "".join(
        f"{i},{r},{c // 100}.{c % 100:02d},r{m:07d}\n"
        for i, (r, c, m) in enumerate(zip(reg, cents, names)))).encode()[:size]
    return data[:data.rfind(b"\n") + 1]


OBJECTS = {
    "/q/one0.csv": csv_object(1, 300_000),
    "/q/one1.csv": csv_object(2, 900_000),
    "/q/one2.csv": csv_object(3, 50_000),
    "/q/three.csv": csv_object(4, 2 * CHUNK + CHUNK // 2),
}
SINGLE = ["/q/one0.csv", "/q/one1.csv", "/q/one2.csv"]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qfilers")
    saved = os.environ.get("SWEED_QUERY_BACKEND")
    os.environ["SWEED_QUERY_BACKEND"] = "numpy"  # the JAX filer's filer-side scan
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volumes = [VolumeServer([str(tmp / f"srv{i}")], port=free_port(), master_url=master.url,
                            max_volume_count=20, pulse_seconds=0.5, ec_backend="cpu").start()
               for i in range(2)]
    filers = {"jax": JFilerServer(port=free_port(), master_url=master.url, chunk_size=CHUNK),
              "port": PFilerServer(port=free_port(), master_url=master.url, chunk_size=CHUNK,
                                   query_backend="cpu")}
    for f in filers.values():
        f.start()
    time.sleep(0.6)
    try:
        for f in filers.values():
            for path, data in OBJECTS.items():
                assert http_bytes("POST", f"http://{f.url}{path}", data)[0] == 201
            assert http_bytes("POST", f"http://{f.url}/q/secret.csv?cipher=true",
                              OBJECTS["/q/one2.csv"])[0] == 201
            assert http_bytes("POST", f"http://{f.url}/q/three.csv.gz",
                              gzip.compress(OBJECTS["/q/three.csv"]))[0] == 201
        yield master, volumes, filers
    finally:
        # the JAX package's asyncio server lingers ~10 s on an idle
        # keep-alive peer when stopped
        threading.Thread(target=filers["jax"].stop, daemon=True).start()
        filers["port"].stop()
        for v in volumes:
            v.stop()
        master.stop()
        if saved is None:
            os.environ.pop("SWEED_QUERY_BACKEND", None)
        else:
            os.environ["SWEED_QUERY_BACKEND"] = saved


def _query(filer, path, req):
    st, body = http_bytes("POST", f"http://{filer.url}/_query",
                          json.dumps(dict(req, path=path, input="csv")).encode())
    return st, json.loads(body)


def test_layout_single_and_multi_chunk(cluster):
    _, _, filers = cluster
    for f in filers.values():
        for path in SINGLE + ["/q/secret.csv"]:
            assert len(http_json("GET", f"http://{f.url}{path}?meta=true")["chunks"]) == 1
        assert len(http_json("GET", f"http://{f.url}/q/three.csv?meta=true")["chunks"]) == 3


@pytest.mark.parametrize("name,req", QUERIES, ids=[q[0] for q in QUERIES])
def test_query_rows_equal_and_pushdown_engaged(cluster, name, req):
    _, volumes, filers = cluster
    served0 = sum(v.queries_served for v in volumes)
    routes0 = filers["port"].query_routes()
    cpu0 = QUERY_COUNTERS["kernel"].value(backend="cpu")
    paths = SINGLE + ["/q/three.csv", "/q/secret.csv"]
    for path in paths:
        want = execute_request(OBJECTS.get(path, OBJECTS["/q/one2.csv"]),
                               dict(req, input="csv"), backend="cpu")
        got = {k: _query(f, path, req) for k, f in filers.items()}
        assert got["port"] == got["jax"] == want, (name, path)
    # both filers push the three single-chunk queries down to the volume
    # servers; the multi-chunk and cipher'd ones scan filer-side
    assert sum(v.queries_served for v in volumes) - served0 == 2 * len(SINGLE)
    routes = filers["port"].query_routes()
    assert routes["pushdown"] - routes0["pushdown"] == len(SINGLE)
    assert routes["filer_side"] - routes0["filer_side"] == 2
    if name != "limit":  # a query with no WHERE evaluates no predicate tree
        assert QUERY_COUNTERS["kernel"].value(backend="cpu") > cpu0
    st = http_json("GET", f"http://{filers['port'].url}/_status")
    assert st["query_routes"] == routes


def test_bad_sql_through_the_pushdown_is_400(cluster):
    _, _, filers = cluster
    for path in ("/q/one0.csv", "/q/three.csv"):
        got = {k: _query(f, path, {"sql": "SELECT FROM WHERE"}) for k, f in filers.items()}
        assert got["port"][0] == got["jax"][0] == 400
        assert got["port"][1]["error"].startswith("bad sql")
    assert _query(filers["port"], "/q/ghost.csv", {"sql": "SELECT * FROM s3object"})[0] == 404


@pytest.mark.parametrize("path,compression", [("/q/three.csv", b"NONE"),
                                              ("/q/three.csv.gz", b"GZIP"),
                                              ("/q/one0.csv", b"NONE")])
def test_select_event_streams_byte_equal(cluster, path, compression):
    _, _, filers = cluster
    body = SELECT_XML % compression
    got = {k: http_bytes("POST", f"http://{f.url}/_select?path={path}", body)
           for k, f in filers.items()}
    assert got["port"][0] == 200
    assert got["port"] == got["jax"]
    events = list(psel.iter_events(got["port"][1]))  # checks every CRC
    rows = b"".join(e["payload"] for e in events if e["headers"][":event-type"] == "Records")
    want = execute_request(OBJECTS[path.removesuffix(".gz")], {
        "input": "csv", "sql": "SELECT * FROM s3object WHERE region = 'east' AND score > 995"},
        backend="cpu")[1]["rows"]
    assert [json.loads(x) for x in rows.splitlines()] == want
    assert [e["headers"][":event-type"] for e in events][-2:] == ["Stats", "End"]


def test_select_error_codes(cluster):
    _, _, filers = cluster
    for f in filers.values():
        st, body = http_bytes("POST", f"http://{f.url}/_select?path=/q/three.csv", b"<nope>")
        assert st == 400 and json.loads(body)["error_code"] == "MalformedXML"
        st, _ = http_bytes("POST", f"http://{f.url}/_select?path=/q/ghost", SELECT_XML % b"NONE")
        assert st == 404


def test_default_backend_without_a_card_fails_naming_the_device(cluster, monkeypatch):
    import torch

    assert not torch.cuda.is_available()
    master, volumes, filers = cluster
    monkeypatch.delenv("SWEED_QUERY_BACKEND", raising=False)
    f = PFilerServer(port=free_port(), master_url=master.url, chunk_size=CHUNK).start()
    try:
        time.sleep(0.3)
        for path, data in OBJECTS.items():
            assert http_bytes("POST", f"http://{f.url}{path}", data)[0] == 201
        cpu0 = QUERY_COUNTERS["kernel"].value(backend="cpu")
        st, body = _query(f, "/q/three.csv", QUERIES[0][1])
        assert st == 500 and "cuda" in body["error"].lower(), body
        st, raw = http_bytes("POST", f"http://{f.url}/_select?path=/q/three.csv",
                             SELECT_XML % b"NONE")
        assert st == 500 and b"CUDA" in raw, raw
        assert QUERY_COUNTERS["kernel"].value(backend="cpu") == cpu0  # nothing scanned on the CPU
        # the pushdown runs on the volume server's own device
        served0 = sum(v.queries_served for v in volumes)
        assert _query(f, "/q/one0.csv", QUERIES[0][1])[0] == 200
        assert sum(v.queries_served for v in volumes) == served0 + 1
        assert f.query_routes() == {"pushdown": 1, "filer_side": 1}
    finally:
        f.stop()
