"""SDK-backed FilerStore adapters: cassandra / mongodb / etcd / elastic —
the port's copy of the JAX package's ``filer/sdk_stores.py``.

Mirrors the reference's thin driver wrappers
(`weed/filer/cassandra/cassandra_store.go:234`, `mongodb/mongodb_store.go:297`,
`etcd/etcd_store.go:252`, `elastic/v7/elastic_store.go:403`): each store maps
the FilerStore interface onto one client library's primitives. Like the
reference, these are only usable where the client SDK is installed — they
raise a loud ImportError otherwise (the same gating shape as
replication.notification.KafkaQueue). The portable stores (memory, sqlite,
generic DB-API SQL, redis RESP) live in filerstore.py / abstract_sql.py /
redis_store.py and carry the test coverage; these adapters reuse the exact
entry serialization those stores pin down.

Data model (shared): an entry is stored as its `Entry.to_dict()` JSON under
(directory, name) — the split the reference uses so directory listings are
one range scan.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

from .entry import Entry
from .filerstore import FilerStore, NotFoundError, _norm


def _split(path: str) -> tuple[str, str]:
    p = _norm(path)
    if p == "/":
        return "/", ""
    d, _, n = p.rpartition("/")
    return d or "/", n


def _ser(entry: Entry) -> bytes:
    return json.dumps(entry.to_dict()).encode()


def _deser(path: str, raw: bytes) -> Entry:
    return Entry.from_dict(json.loads(raw))


class CassandraStore(FilerStore):
    """CQL keyspace with the reference's `filemeta` table
    (cassandra_store.go:36-57): PRIMARY KEY (directory, name)."""

    def __init__(self, hosts: list[str], keyspace: str = "seaweedfs",
                 username: str = "", password: str = "", port: int = 9042):
        try:
            from cassandra.cluster import Cluster  # type: ignore
            from cassandra.auth import PlainTextAuthProvider  # type: ignore
        except ImportError as e:
            raise ImportError(
                "CassandraStore needs the 'cassandra-driver' package; use "
                "the sqlite/sql/redis stores where it is unavailable"
            ) from e
        auth = (
            PlainTextAuthProvider(username=username, password=password)
            if username else None
        )
        self._cluster = Cluster(hosts, port=port, auth_provider=auth)
        self._s = self._cluster.connect(keyspace)
        self._s.execute(
            "CREATE TABLE IF NOT EXISTS filemeta (directory varchar, "
            "name varchar, meta blob, PRIMARY KEY (directory, name))"
        )
        self._s.execute(
            "CREATE TABLE IF NOT EXISTS key_value (key blob PRIMARY KEY, "
            "value blob)"
        )

    def insert_entry(self, entry: Entry) -> None:
        d, n = _split(entry.full_path)
        self._s.execute(
            "INSERT INTO filemeta (directory, name, meta) VALUES (%s,%s,%s)",
            (d, n, _ser(entry)),
        )

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        d, n = _split(path)
        rows = self._s.execute(
            "SELECT meta FROM filemeta WHERE directory=%s AND name=%s", (d, n)
        )
        row = rows.one()
        if row is None:
            raise NotFoundError(path)
        return _deser(path, bytes(row.meta))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        self._s.execute(
            "DELETE FROM filemeta WHERE directory=%s AND name=%s", (d, n)
        )

    def delete_folder_children(self, path: str) -> None:
        # direct children only: the partition key admits equality, not
        # ranges — exactly the reference's behavior (cassandra_store.go
        # DeleteFolderChildren). Subtree recursion happens in the filer
        # (filer.py _delete_entry walks directories), so nothing is lost.
        self._s.execute(
            "DELETE FROM filemeta WHERE directory=%s", (_norm(path),)
        )

    def list_entries(self, dir_path: str, start_after: str = "",
                     limit: int = 1000) -> Iterator[Entry]:
        rows = self._s.execute(
            "SELECT name, meta FROM filemeta WHERE directory=%s AND "
            "name>%s LIMIT %s",
            (_norm(dir_path), start_after, limit),
        )
        for row in rows:
            yield _deser(f"{dir_path}/{row.name}", bytes(row.meta))

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._s.execute(
            "INSERT INTO key_value (key, value) VALUES (%s,%s)", (key, value)
        )

    def kv_get(self, key: bytes) -> Optional[bytes]:
        row = self._s.execute(
            "SELECT value FROM key_value WHERE key=%s", (key,)
        ).one()
        return bytes(row.value) if row else None

    def kv_delete(self, key: bytes) -> None:
        self._s.execute("DELETE FROM key_value WHERE key=%s", (key,))

    def close(self) -> None:
        self._cluster.shutdown()


class MongoStore(FilerStore):
    """`filemeta` collection keyed on (directory, name)
    (mongodb_store.go:45-66)."""

    def __init__(self, uri: str = "mongodb://127.0.0.1:27017",
                 database: str = "seaweedfs"):
        try:
            import pymongo  # type: ignore
        except ImportError as e:
            raise ImportError(
                "MongoStore needs the 'pymongo' package; use the sqlite/"
                "sql/redis stores where it is unavailable"
            ) from e
        self._client = pymongo.MongoClient(uri)
        db = self._client[database]
        self._c = db["filemeta"]
        self._kv = db["key_value"]
        self._c.create_index([("directory", 1), ("name", 1)], unique=True)

    def insert_entry(self, entry: Entry) -> None:
        d, n = _split(entry.full_path)
        self._c.replace_one(
            {"directory": d, "name": n},
            {"directory": d, "name": n, "meta": _ser(entry)},
            upsert=True,
        )

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        d, n = _split(path)
        doc = self._c.find_one({"directory": d, "name": n})
        if doc is None:
            raise NotFoundError(path)
        return _deser(path, bytes(doc["meta"]))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        self._c.delete_one({"directory": d, "name": n})

    def delete_folder_children(self, path: str) -> None:
        import re

        # whole subtree, matching the portable stores' contract; root's
        # nested matcher must be "/" not "//" (abstract_sql rstrip parity)
        p = _norm(path)
        nested = (p.rstrip("/") + "/")
        self._c.delete_many({"$or": [
            {"directory": p},
            {"directory": {"$regex": "^" + re.escape(nested)}},
        ]})

    def list_entries(self, dir_path: str, start_after: str = "",
                     limit: int = 1000) -> Iterator[Entry]:
        cur = (
            self._c.find({"directory": _norm(dir_path),
                          "name": {"$gt": start_after}})
            .sort("name", 1)
            .limit(limit)
        )
        for doc in cur:
            yield _deser(f"{dir_path}/{doc['name']}", bytes(doc["meta"]))

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._kv.replace_one({"_id": key}, {"_id": key, "value": value},
                             upsert=True)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        doc = self._kv.find_one({"_id": key})
        return bytes(doc["value"]) if doc else None

    def kv_delete(self, key: bytes) -> None:
        self._kv.delete_one({"_id": key})

    def close(self) -> None:
        self._client.close()


class EtcdStore(FilerStore):
    """Entries under a key prefix, one key per path; listings are prefix
    range reads (etcd_store.go:24-43 DIR_FILE_SEPARATOR layout)."""

    def __init__(self, endpoint: str = "127.0.0.1:2379",
                 prefix: str = "seaweedfs."):
        try:
            import etcd3  # type: ignore
        except ImportError as e:
            raise ImportError(
                "EtcdStore needs the 'etcd3' package; use the sqlite/sql/"
                "redis stores where it is unavailable"
            ) from e
        host, _, port = endpoint.partition(":")
        self._c = etcd3.client(host=host, port=int(port or 2379))
        self._p = prefix

    def _key(self, path: str) -> str:
        d, n = _split(path)
        return f"{self._p}{d}\x00{n}"

    def insert_entry(self, entry: Entry) -> None:
        self._c.put(self._key(entry.full_path), _ser(entry))

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        raw, _ = self._c.get(self._key(path))
        if raw is None:
            raise NotFoundError(path)
        return _deser(path, raw)

    def delete_entry(self, path: str) -> None:
        self._c.delete(self._key(path))

    def delete_folder_children(self, path: str) -> None:
        # two prefixes cover the subtree without clipping siblings:
        # "<dir>\x00" = direct children, "<dir rstripped>/" = all nested
        # directories ("/a" must not match "/ab\x00..."; root's nested
        # prefix is "/", not "//")
        p = _norm(path)
        self._c.delete_prefix(f"{self._p}{p}\x00")
        self._c.delete_prefix(f"{self._p}{p.rstrip('/')}/")

    def list_entries(self, dir_path: str, start_after: str = "",
                     limit: int = 1000) -> Iterator[Entry]:
        count = 0
        prefix = f"{self._p}{_norm(dir_path)}\x00"
        # server-side range from just past the cursor; `limit` is pushed to
        # etcd where the client supports it (RangeRequest.limit), so a page
        # transfers only its own entries — older python-etcd3 falls back to
        # fetching the range tail and breaking locally
        kwargs = {"sort_order": "ascend", "sort_target": "key"}
        if start_after:
            import etcd3.utils as _u  # type: ignore

            args = (prefix + start_after + "\x00",
                    _u.prefix_range_end(_u.to_bytes(prefix)))
            fetch = self._c.get_range
        else:
            args = (prefix,)
            fetch = self._c.get_prefix
        try:
            it = fetch(*args, limit=limit, **kwargs)
        except TypeError:
            it = fetch(*args, **kwargs)
        for raw, meta in it:
            if count >= limit:
                break  # keys arrive ascending: nothing more to take
            name = meta.key.decode()[len(prefix):]
            count += 1
            yield _deser(f"{dir_path}/{name}", raw)

    def kv_put(self, key: bytes, value: bytes) -> None:
        self._c.put(self._p + "kv." + key.hex(), value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        raw, _ = self._c.get(self._p + "kv." + key.hex())
        return raw

    def kv_delete(self, key: bytes) -> None:
        self._c.delete(self._p + "kv." + key.hex())

    def close(self) -> None:
        self._c.close()


class ElasticStore(FilerStore):
    """Documents in one index, id = urlsafe path (elastic v7
    elastic_store.go:55-88)."""

    def __init__(self, servers: list[str], index: str = "seaweedfs"):
        try:
            from elasticsearch import Elasticsearch  # type: ignore
        except ImportError as e:
            raise ImportError(
                "ElasticStore needs the 'elasticsearch' package; use the "
                "sqlite/sql/redis stores where it is unavailable"
            ) from e
        import base64

        import elasticsearch as _es  # type: ignore

        self._b64 = base64.urlsafe_b64encode
        self._c = Elasticsearch(servers)
        self._index = index
        self._not_found = _es.NotFoundError

    def _id(self, path: str) -> str:
        return self._b64(_norm(path).encode()).decode()

    def insert_entry(self, entry: Entry) -> None:
        d, n = _split(entry.full_path)
        # refresh=wait_for: the filer's metadata reads are
        # read-your-writes everywhere else (a directory listing issued
        # right after a create MUST see the entry — _delete_entry counts
        # children through list_entries); default async refresh would
        # make just-written entries invisible for up to a second
        self._c.index(
            index=self._index, id=self._id(entry.full_path),
            body={"directory": d, "name": n,
                  "meta": _ser(entry).decode()},
            refresh="wait_for",
        )

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        try:
            doc = self._c.get(index=self._index, id=self._id(path))
        except self._not_found as e:
            # ONLY the index miss maps to NotFound; transport/connection
            # errors must propagate (an outage is not "file absent")
            raise NotFoundError(path) from e
        return _deser(path, doc["_source"]["meta"].encode())

    def delete_entry(self, path: str) -> None:
        try:
            self._c.delete(index=self._index, id=self._id(path),
                           refresh="wait_for")
        except self._not_found:
            pass

    def delete_folder_children(self, path: str) -> None:
        p = _norm(path)
        self._c.delete_by_query(
            index=self._index, refresh=True,
            body={"query": {"bool": {"should": [
                {"term": {"directory.keyword": p}},
                {"prefix": {"directory.keyword": p.rstrip("/") + "/"}},
            ], "minimum_should_match": 1}}},
        )

    def list_entries(self, dir_path: str, start_after: str = "",
                     limit: int = 1000) -> Iterator[Entry]:
        res = self._c.search(
            index=self._index,
            body={
                "size": limit,
                "sort": [{"name.keyword": "asc"}],
                "query": {
                    "bool": {
                        "must": [{"term": {"directory.keyword": _norm(dir_path)}}],
                        "filter": [{"range": {"name.keyword": {"gt": start_after}}}],
                    }
                },
            },
        )
        for hit in res["hits"]["hits"]:
            src = hit["_source"]
            yield _deser(f"{dir_path}/{src['name']}", src["meta"].encode())

    def kv_put(self, key: bytes, value: bytes) -> None:
        # no refresh: kv_get fetches by document id, which is realtime in
        # ES — waiting for an index refresh would only add write latency
        self._c.index(index=self._index + "_kv", id=key.hex(),
                      body={"value": value.hex()})

    def kv_get(self, key: bytes) -> Optional[bytes]:
        try:
            doc = self._c.get(index=self._index + "_kv", id=key.hex())
        except self._not_found:  # outages propagate; only misses are None
            return None
        return bytes.fromhex(doc["_source"]["value"])

    def kv_delete(self, key: bytes) -> None:
        try:
            self._c.delete(index=self._index + "_kv", id=key.hex())
        except self._not_found:
            pass

    def close(self) -> None:
        self._c.close()
