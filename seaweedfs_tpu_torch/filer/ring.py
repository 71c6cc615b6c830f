"""Path-prefix sharding of the directory tree across a filer fleet: the
port's copy of the JAX package's ``filer/ring.py``.

One filer's store bounds the whole cluster's metadata throughput. The tree
is split by the first ``SWEED_RING_DEPTH`` path segments (default 2 —
``/bucket/toplevel``), and each shard key maps onto one filer via
:class:`~..messaging.consistent.ConsistentRing`. Everything below a shard
root lives on that shard's filer, so a subtree's metadata ops never cross
filers.

Two kinds of path, two placement rules:

- **shard paths** (>= depth segments): owned by exactly one filer —
  ``owner(path)`` = ring.get(shard key). The whole subtree under a shard
  root shares its key, so recursive ops stay single-filer.
- **spine dirs** (< depth segments, e.g. ``/`` and ``/bucket``): exist on
  EVERY filer. Spine listings fan out to all members and merge; spine
  mkdir/delete fan out too. This keeps ``ls /bucket`` correct without a
  directory-location service.

Ring placement is a pure function of the member set, so every daemon and
client, of either package, computes identical ownership from the same
``ring_peers`` list — no coordination service.

:class:`RingFilerClient` is the smart client: same surface as
:class:`~.client.FilerClient`, but routes each call to the owner and
fans out spine ops. Dumb clients keep working because an owning filer
answers reads for foreign paths with ``307 Location:`` (and proxies
writes) — see server/filer_server.py; plain FilerClient follows the
redirect. ``make_client`` gives the S3 gateway and the fsspec client one
or the other from their ``-filer`` value.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from ..messaging.consistent import ConsistentRing
from .client import FilerClient, FilerHTTPError


def ring_depth() -> int:
    """How many leading path segments form the shard key."""
    raw = os.environ.get("SWEED_RING_DEPTH", "2").strip()
    if not (raw.isascii() and raw.isdigit()) or int(raw) < 1:
        return 2
    return int(raw)


def _segments(path: str) -> list[str]:
    return [s for s in path.strip("/").split("/") if s]


def shard_key(path: str, depth: Optional[int] = None) -> str:
    """The ring key for ``path``: its first ``depth`` segments (fewer if
    the path is shorter). ``/`` maps to itself."""
    depth = depth if depth is not None else ring_depth()
    segs = _segments(path)
    if not segs:
        return "/"
    return "/" + "/".join(segs[:depth])


class FilerRing:
    """Ownership map for one fleet: ``members`` are filer addresses
    (``host:port``). A <2-member ring is inert — every path is owned
    locally and no redirects/fan-out happen, which is what keeps the
    single filer serving exactly as it does without a ring."""

    def __init__(self, members: list[str], self_url: str = "",
                 depth: Optional[int] = None):
        self.depth = depth if depth is not None else ring_depth()
        self.self_url = self_url
        self._ring = ConsistentRing()
        seen = set()
        for m in members:
            m = m.strip()
            if m and m not in seen:
                seen.add(m)
                self._ring.add(m)

    @property
    def active(self) -> bool:
        return len(self._ring) > 1

    def members(self) -> list[str]:
        return self._ring.members()

    def is_spine(self, path: str) -> bool:
        """Spine dirs (< depth segments) exist on every filer."""
        return len(_segments(path)) < self.depth

    def owner(self, path: str) -> str:
        if not self.active:
            return self.self_url
        return self._ring.get(shard_key(path, self.depth))

    def owns(self, path: str) -> bool:
        """Does THIS filer serve ``path``? Spine paths: everyone does."""
        if not self.active or self.is_spine(path):
            return True
        return self.owner(path) == self.self_url

    def plan(self) -> dict:
        """Shard layout for /_ring introspection and reshard planning."""
        return {
            "depth": self.depth,
            "members": self.members(),
            "self": self.self_url,
            "active": self.active,
        }


class RingFilerClient:
    """Drop-in for FilerClient that routes by ring ownership.

    Single-path ops go straight to the owner (no redirect hop); spine
    listings fan out to every member and merge by name; spine
    mkdir/delete fan out. Gateways (client/fs.py, s3api) construct this
    when handed multiple filer addresses and keep their code unchanged —
    the surface is FilerClient's."""

    def __init__(self, filer_urls: list[str], retry_reads: bool = True,
                 depth: Optional[int] = None,
                 client_factory: Callable[..., FilerClient] = FilerClient):
        if not filer_urls:
            raise ValueError("RingFilerClient needs at least one filer")
        self.ring = FilerRing(filer_urls, self_url=filer_urls[0], depth=depth)
        self._clients = {
            u: client_factory(u, retry_reads=retry_reads)
            for u in self.ring.members()
        }
        # non-path ops (assign/status/kv/meta_events) pin to one home
        # filer so sequences like kv_put → kv_get stay on one store
        self._home = self._clients[self.ring.members()[0]]
        self.base = self._home.base

    def _c(self, path: str) -> FilerClient:
        return self._clients[self.ring.owner(path)]

    def _u(self, path: str, **q) -> str:
        """Owner-routed URL for ``path`` — gateways' zero-copy fast paths
        build raw filer URLs (s3api native GET) and must aim at the shard
        that holds the entry, not redirect off the home filer."""
        return self._c(path)._u(path, **q)

    def _all(self) -> list[FilerClient]:
        return [self._clients[m] for m in self.ring.members()]

    # -- object level ---------------------------------------------------------
    def put_object(self, path: str, body: bytes, content_type: str = "",
                   extended: Optional[dict] = None,
                   signatures: Optional[list[int]] = None) -> dict:
        return self._c(path).put_object(
            path, body, content_type=content_type, extended=extended,
            signatures=signatures)

    def put_object_stream(self, path: str, rfile, length: int,
                          content_type: str = "",
                          extended: Optional[dict] = None) -> dict:
        return self._c(path).put_object_stream(
            path, rfile, length, content_type=content_type, extended=extended)

    def get_object(self, path: str, rng: Optional[str] = None):
        return self._c(path).get_object(path, rng=rng)

    def get_object_stream(self, path: str, rng: Optional[str] = None):
        return self._c(path).get_object_stream(path, rng=rng)

    def select(self, path: str, request_xml: bytes):
        return self._c(path).select(path, request_xml)

    # -- entry level ----------------------------------------------------------
    def get_entry(self, path: str) -> Optional[dict]:
        if self.ring.active and self.ring.is_spine(path):
            # spine dirs exist per-filer; first hit wins (they're replicas)
            for c in self._all():
                e = c.get_entry(path)
                if e is not None:
                    return e
            return None
        return self._c(path).get_entry(path)

    def create_entry(self, path: str, entry: dict,
                     signatures: Optional[list[int]] = None) -> None:
        self._c(path).create_entry(path, entry, signatures=signatures)

    def mkdir(self, path: str, signatures: Optional[list[int]] = None) -> None:
        if self.ring.active and self.ring.is_spine(path):
            for c in self._all():
                c.mkdir(path, signatures=signatures)
            return
        self._c(path).mkdir(path, signatures=signatures)

    def delete(self, path: str, recursive: bool = False,
               skip_chunk_purge: bool = False,
               signatures: Optional[list[int]] = None) -> int:
        if self.ring.active and self.ring.is_spine(path):
            worst = 0
            for c in self._all():
                s = c.delete(path, recursive=recursive,
                             skip_chunk_purge=skip_chunk_purge,
                             signatures=signatures)
                worst = max(worst, s if s != 404 else 0)
            # a spine dir absent on some members is still a success: 404s
            # only count when NOBODY had it
            return worst or 404
        return self._c(path).delete(
            path, recursive=recursive, skip_chunk_purge=skip_chunk_purge,
            signatures=signatures)

    def list(self, dir_path: str, start_after: str = "", limit: int = 1000,
             prefix: str = "") -> list[dict]:
        if not (self.ring.active and self.ring.is_spine(dir_path)):
            return self._c(dir_path).list(
                dir_path, start_after=start_after, limit=limit, prefix=prefix)
        # spine listing: fan out and merge by name. Children of a spine
        # dir may live anywhere (depth-boundary entries are sharded;
        # deeper spine dirs are replicated on every member) — dedupe by
        # name, keep the richest copy, present one sorted view.
        merged: dict[str, dict] = {}
        for c in self._all():
            for e in c.list(dir_path, start_after=start_after,
                            limit=limit, prefix=prefix):
                name = e.get("name", "")
                prev = merged.get(name)
                if prev is None or (
                        not prev.get("is_directory") and e.get("is_directory")):
                    merged[name] = e
        return [merged[k] for k in sorted(merged)][:limit]

    def rename(self, old: str, new: str) -> None:
        if not self.ring.active or self.ring.owner(old) == self.ring.owner(new):
            self._c(old).rename(old, new)
            return
        self._move_tree(old, new)

    def _move_tree(self, old: str, new: str) -> None:
        """Cross-shard rename: entry-level copy to the new owner, then a
        metadata-only delete at the old (chunks stay put — fids don't
        change, exactly the reshard discipline)."""
        src, dst = self._c(old), self._c(new)
        entry = src.get_entry(old)
        if entry is None:
            raise FilerHTTPError("MOVE", old, 404)
        self._copy_tree(src, dst, old, new, entry)
        src.delete(old, recursive=True, skip_chunk_purge=True)

    def _copy_tree(self, src: FilerClient, dst: FilerClient,
                   old: str, new: str, entry: dict) -> None:
        entry = dict(entry)
        entry["full_path"] = new
        dst.create_entry(new, entry)
        if entry.get("is_directory"):
            cursor = ""
            while True:
                page = src.list(old, start_after=cursor, limit=1000)
                if not page:
                    break
                for child in page:
                    cursor = child["name"]
                    ce = src.get_entry(f"{old.rstrip('/')}/{child['name']}")
                    if ce is not None:
                        self._copy_tree(
                            src, dst,
                            f"{old.rstrip('/')}/{child['name']}",
                            f"{new.rstrip('/')}/{child['name']}", ce)
                if len(page) < 1000:
                    break

    # -- passthrough (non-path-routed) ----------------------------------------
    def assign(self, count: int = 1, collection: str = "", ttl: str = "") -> dict:
        return self._home.assign(count=count, collection=collection, ttl=ttl)

    def status(self) -> dict:
        return self._home.status()

    def meta_events(self, since_ns: int = 0, limit: int = 1000) -> dict:
        return self._home.meta_events(since_ns=since_ns, limit=limit)

    def kv_put(self, key: str, value: bytes) -> None:
        self._home.kv_put(key, value)

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._home.kv_get(key)

    def kv_delete(self, key: str) -> None:
        self._home.kv_delete(key)


def make_client(filers: "str | list[str]", retry_reads: bool = True):
    """One factory for every gateway: a single address → plain
    FilerClient (zero behavior change); several → RingFilerClient.
    Accepts 'host:p1,host:p2' strings so CLI flags stay one value."""
    if isinstance(filers, str):
        filers = [f for f in filers.split(",") if f.strip()]
    if len(filers) <= 1:
        return FilerClient(filers[0], retry_reads=retry_reads)
    return RingFilerClient(filers, retry_reads=retry_reads)
