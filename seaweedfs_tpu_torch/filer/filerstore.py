"""FilerStore plugins: the uniform KV/SQL adapter interface.

The port's copy of the JAX package's ``filer/filerstore.py`` (after
`weed/filer/filerstore.go:20`): insert/update/find/delete/
delete_folder_children/list + KV. Implementations:

- MemoryStore (here): dict-backed (``-db :memory:`` and tests)
- SqliteStore / AbstractSqlStore / GenericSqlStore (abstract_sql.py):
  the SQL family, embedded sqlite by default (the filer's store), any
  DB-API driver by name (`abstract_sql/abstract_sql_store.go`)
- RedisStore (redis_store.py): redis-protocol networked store
  (`redis2/universal_redis_store.go`)
- CassandraStore / MongoStore / EtcdStore / ElasticStore (sdk_stores.py):
  over their client SDKs, which raise ImportError where those are missing
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

from .entry import Entry


class NotFoundError(KeyError):
    pass


class FilerStore:
    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, path: str) -> Entry:
        raise NotImplementedError

    def delete_entry(self, path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, path: str) -> None:
        raise NotImplementedError

    def list_entries(
        self, dir_path: str, start_after: str = "", limit: int = 1000
    ) -> Iterator[Entry]:
        raise NotImplementedError

    # KV (filerstore.go KvPut/KvGet — used for offsets/checkpoints)
    def kv_put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def kv_delete(self, key: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _norm(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    if len(path) > 1:
        path = path.rstrip("/")
    return path


class MemoryStore(FilerStore):
    def __init__(self) -> None:
        self._entries: dict[str, Entry] = {}
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._entries[_norm(entry.full_path)] = entry

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        e = self._entries.get(_norm(path))
        if e is None:
            raise NotFoundError(path)
        return e

    def delete_entry(self, path: str) -> None:
        with self._lock:
            self._entries.pop(_norm(path), None)

    def delete_folder_children(self, path: str) -> None:
        prefix = _norm(path)
        prefix = prefix if prefix.endswith("/") else prefix + "/"
        with self._lock:
            for k in [k for k in self._entries if k.startswith(prefix)]:
                del self._entries[k]

    def list_entries(self, dir_path: str, start_after: str = "", limit: int = 1000):
        d = _norm(dir_path)
        d_prefix = d if d.endswith("/") else d + "/"
        names = []
        with self._lock:
            for k, e in self._entries.items():
                if k.startswith(d_prefix) and "/" not in k[len(d_prefix) :]:
                    names.append((k[len(d_prefix) :], e))
        names.sort()
        count = 0
        for name, e in names:
            if start_after and name <= start_after:
                continue
            yield e
            count += 1
            if count >= limit:
                return

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._kv[key] = value

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self._kv.get(key)

    def kv_delete(self, key: bytes) -> None:
        self._kv.pop(key, None)


def __getattr__(name):
    # SqliteStore/AbstractSqlStore live in abstract_sql (which imports this
    # module for the base class); resolve lazily to avoid the cycle while
    # keeping `from .filerstore import SqliteStore` working everywhere
    if name in ("SqliteStore", "AbstractSqlStore", "GenericSqlStore"):
        from . import abstract_sql

        return getattr(abstract_sql, name)
    raise AttributeError(name)
