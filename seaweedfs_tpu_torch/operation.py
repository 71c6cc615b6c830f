"""Client operations: the ``assign`` and ``lookup`` that ``benchmark`` uses.

The subset of the JAX package's ``operation.py`` (after `weed/operation/`:
assign_file_id.go:36, lookup.go) that the port needs so far. An assign with
``count=N`` reserves N consecutive needle keys under one cookie; the
caller addresses key ``i`` as ``<fid>_<i>`` (the ``fid_<delta>`` form that
``storage/file_id.py`` parses). Upload, download, delete and submit come
with the filer and its clients.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .server.http_util import http_json


@dataclass
class Assignment:
    fid: str
    url: str
    public_url: str
    count: int
    replicas: list[str] = field(default_factory=list)
    auth: str = ""  # the master's fid-scoped write JWT (jwt.go GenJwt)


def assign(master: str, count: int = 1, replication: str = "", collection: str = "",
           ttl: str = "", data_center: str = "") -> Assignment:
    q = (f"count={count}&replication={replication}&collection={collection}"
         f"&ttl={ttl}&dataCenter={data_center}")
    r = http_json("POST", f"http://{master}/dir/assign?{q}")
    if r.get("error"):
        raise RuntimeError(f"assign: {r['error']}")
    return Assignment(fid=r["fid"], url=r["url"], public_url=r.get("publicUrl", r["url"]),
                      count=r.get("count", count), replicas=r.get("replicas", []),
                      auth=r.get("auth", ""))


def lookup(master: str, vid: int) -> list[dict]:
    r = http_json("GET", f"http://{master}/dir/lookup?volumeId={vid}")
    return r.get("locations", [])
