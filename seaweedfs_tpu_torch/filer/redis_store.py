"""Redis-protocol FilerStore — networked metadata store: the port's copy of
the JAX package's ``filer/redis_store.py``.

Mirrors `weed/filer/redis2/universal_redis_store.go`: each entry is a
string value at its full path; each directory keeps a sorted set
(`<dir>\\x00`) of child names so listings page lexicographically
(ZRANGEBYLEX, which also gives exclusive start-after semantics for free).
KV checkpoints ride the same keyspace under a binary prefix. The keys and
values are the JAX package's, so either package's filer reads the other's
redis.

The wire client is a dependency-free RESP2 implementation over stdlib
sockets — any redis/valkey-compatible server works, including the
in-package `util.mini_redis` stand-in used by tests.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Iterator, Optional

from ..util.resp import BufferedRespReader
from .entry import Entry
from .filerstore import FilerStore, NotFoundError, _norm

DIR_LIST_SUFFIX = b"\x00"
KV_PREFIX = b"\x01kv\x01"


class RespError(RuntimeError):
    pass


class RespClient:
    """Minimal RESP2 client: encode command arrays, parse replies."""

    def __init__(
        self,
        address: str = "127.0.0.1:6379",
        password: str = "",
        database: int = 0,
        timeout: float = 10.0,
    ):
        if ":" in address:
            host, _, port_s = address.rpartition(":")
            port = int(port_s)
        else:
            host, port = address, 6379  # bare hostname: default redis port
        self._sock = socket.create_connection(
            (host or "127.0.0.1", port), timeout=timeout
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = BufferedRespReader(lambda: self._sock.recv(65536))
        self._lock = threading.Lock()
        if password:
            self.execute("AUTH", password)
        if database:
            self.execute("SELECT", str(database))

    # -- wire ---------------------------------------------------------------
    @staticmethod
    def _enc(args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            if isinstance(a, str):
                a = a.encode()
            elif isinstance(a, (int, float)):
                a = str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(a), a))
        return b"".join(out)

    def _read_reply(self):
        line = self._reader.read_line()
        if line is None:
            raise RespError("connection closed")
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            out = self._reader.read_exact(n)
            if out is None:
                raise RespError("connection closed")
            return out
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self._read_reply() for _ in range(n)]
        raise RespError(f"bad reply type {line!r}")

    def execute(self, *args):
        with self._lock:
            self._sock.sendall(self._enc(args))
            return self._read_reply()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class RedisStore(FilerStore):
    def __init__(
        self,
        address: str = "127.0.0.1:6379",
        password: str = "",
        database: int = 0,
    ):
        self._client = RespClient(address, password=password, database=database)

    # -- keys ---------------------------------------------------------------
    @staticmethod
    def _dir_list_key(dir_path: str) -> bytes:
        return _norm(dir_path).encode() + DIR_LIST_SUFFIX

    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        path = _norm(path)
        if path == "/":
            return "", ""
        d, _, name = path.rpartition("/")
        return d or "/", name

    # -- entries ------------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        path = _norm(entry.full_path)
        value = json.dumps(entry.to_dict()).encode()
        args = ["SET", path, value]
        ttl = getattr(entry, "ttl_sec", 0)
        if ttl:
            args += ["EX", ttl]
        self._client.execute(*args)
        d, name = self._split(path)
        if name:
            self._client.execute("ZADD", self._dir_list_key(d), 0, name)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        data = self._client.execute("GET", _norm(path))
        if data is None:
            raise NotFoundError(path)
        return Entry.from_dict(json.loads(data))

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        self._client.execute("DEL", path, path.encode() + DIR_LIST_SUFFIX)
        d, name = self._split(path)
        if name:
            self._client.execute("ZREM", self._dir_list_key(d), name)

    def delete_folder_children(self, path: str) -> None:
        key = self._dir_list_key(path)
        children = self._client.execute("ZRANGE", key, 0, -1) or []
        base = _norm(path)
        for name in children:
            child = (base.rstrip("/") + "/" + name.decode())
            # recurse: a child with its own dir-list set is a directory
            if self._client.execute(
                "EXISTS", child.encode() + DIR_LIST_SUFFIX
            ):
                self.delete_folder_children(child)
            self._client.execute(
                "DEL", child, child.encode() + DIR_LIST_SUFFIX
            )
        self._client.execute("DEL", key)

    def list_entries(
        self, dir_path: str, start_after: str = "", limit: int = 1000
    ) -> Iterator[Entry]:
        key = self._dir_list_key(dir_path)
        lo = b"(" + start_after.encode() if start_after else b"-"
        names = (
            self._client.execute(
                "ZRANGEBYLEX", key, lo, b"+", "LIMIT", 0, limit
            )
            or []
        )
        base = _norm(dir_path).rstrip("/")
        for name in names:
            try:
                yield self.find_entry(f"{base}/{name.decode()}")
            except NotFoundError:
                # entry expired / deleted out-of-band: drop the stale member
                self._client.execute("ZREM", key, name)

    # -- kv -----------------------------------------------------------------
    def kv_put(self, key: bytes, value: bytes) -> None:
        self._client.execute("SET", KV_PREFIX + key, value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._client.execute("GET", KV_PREFIX + key)

    def kv_delete(self, key: bytes) -> None:
        self._client.execute("DEL", KV_PREFIX + key)

    def close(self) -> None:
        self._client.close()
