"""The port filer's ``/_query`` pushdown tries every holder of the needle.

A port master and two port volume servers hold a replicated (``001``)
single-chunk CSV, written through the port filer and through the JAX
package's filer. The server that the port filer's lookup names first for its
needle is stopped: the port filer hands the query to the next holder, which
scans it (``query_routes`` counts a pushdown, the live server a scan), and
its rows equal the JAX filer's reply for the same query.
"""

import json
import socket
import threading
import time

import numpy as np

from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu_torch.query import execute_request
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PFilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer

PATH = "/q/rep.csv"
SQL = "SELECT id, name FROM s3object WHERE region = 'east' AND score > 900"


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def csv_object(seed: int, size: int) -> bytes:
    """Rows of ``id,region,score,name`` from a seed, whole rows under
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


def _query(filer, path):
    st, body = http_bytes("POST", f"http://{filer.url}/_query",
                          json.dumps({"path": path, "input": "csv", "sql": SQL}).encode())
    return st, json.loads(body)


def test_pushdown_fails_over_to_the_next_holder(tmp_path, monkeypatch):
    monkeypatch.setenv("SWEED_QUERY_BACKEND", "numpy")  # the JAX filer's filer-side scan
    data = csv_object(9, 200_000)
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volumes = {}
    for i in range(2):
        vs = VolumeServer([str(tmp_path / f"srv{i}")], port=free_port(), master_url=master.url,
                          max_volume_count=20, pulse_seconds=0.3, ec_backend="cpu").start()
        volumes[f"127.0.0.1:{vs.port}"] = vs
    filers = {"jax": JFilerServer(port=free_port(), master_url=master.url,
                                  replication="001"),
              "port": PFilerServer(port=free_port(), master_url=master.url,
                                   replication="001", query_backend="cpu")}
    stopped = set()
    try:
        for f in filers.values():
            f.start()
        deadline = time.time() + 20
        while len(master.master.topo.data_nodes()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        for f in filers.values():
            assert http_bytes("POST", f"http://{f.url}{PATH}", data)[0] == 201
        chunks = {k: http_json("GET", f"http://{f.url}{PATH}?meta=true")["chunks"]
                  for k, f in filers.items()}
        assert [len(c) for c in chunks.values()] == [1, 1]
        pf = filers["port"]
        vid = int(chunks["port"][0]["file_id"].split(",")[0])
        holders = [loc["url"] for loc in pf._lookup.lookup(vid)]
        assert len(holders) == 2
        first = holders[0]
        want = execute_request(data, {"input": "csv", "sql": SQL}, backend="cpu")

        volumes[first].stop()
        stopped.add(first)
        live = next(vs for url, vs in volumes.items() if url != first)
        assert pf._lookup.lookup(vid)[0]["url"] == first
        routes0, served0 = pf.query_routes(), live.queries_served
        got = {k: _query(f, PATH) for k, f in filers.items()}
        assert got["port"] == got["jax"] == want
        routes = pf.query_routes()
        assert routes["pushdown"] - routes0["pushdown"] == 1
        assert routes["filer_side"] == routes0["filer_side"]
        # the port filer's query was scanned by the live holder (the JAX
        # filer's may have been too)
        assert live.queries_served - served0 >= 1
    finally:
        threading.Thread(target=filers["jax"].stop, daemon=True).start()
        filers["port"].stop()
        for url, vs in volumes.items():
            if url not in stopped:
                vs.stop()
        master.stop()
