"""SQL FilerStore over a DB-API 2.0 connection.

The port's copy of the JAX package's ``filer/abstract_sql.py`` (after
`weed/filer/abstract_sql/abstract_sql_store.go`): one ``filemeta`` table
keyed (dir, name) with the entry's JSON as its meta column, plus a ``kv``
table for checkpoints and signatures. The schema is the JAX package's, so
one ``filer.db`` serves either package's filer. Only the embedded sqlite
dialect is ported (``SqliteStore``, the filer's default store); the
networked drivers (``GenericSqlStore``) are not ported yet.
"""

from __future__ import annotations

import json
import threading
from typing import Iterator, Optional

from .entry import Entry
from .filerstore import FilerStore, NotFoundError, _norm

# the schema of abstract_sql_store.go's sqlite flavour
_FILEMETA_DDL = ("CREATE TABLE IF NOT EXISTS filemeta ("
                 " dir TEXT NOT NULL, name TEXT NOT NULL, meta TEXT NOT NULL,"
                 " PRIMARY KEY (dir, name))")
_KV_DDL = "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)"
_UPSERT = "INSERT OR REPLACE INTO {table} ({cols}) VALUES ({ph})"


class AbstractSqlStore(FilerStore):
    """All six FilerStore ops + KV as SQL over a DB-API connection whose
    paramstyle is qmark (sqlite3's)."""

    def __init__(self, conn):
        self._db = conn
        self._ph = "?"
        self._lock = threading.RLock()
        self._create_tables()

    def _create_tables(self) -> None:
        with self._lock:
            cur = self._db.cursor()
            cur.execute(_FILEMETA_DDL)
            cur.execute(_KV_DDL)
            self._db.commit()

    def _upsert_sql(self, table: str, cols: str, nvals: int) -> str:
        return _UPSERT.format(table=table, cols=cols, ph=",".join([self._ph] * nvals))

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _split(path: str) -> tuple[str, str]:
        path = _norm(path)
        if path == "/":
            return "", "/"
        d, _, name = path.rpartition("/")
        return d or "/", name

    def _exec(self, sql: str, params: tuple = ()):
        cur = self._db.cursor()
        cur.execute(sql, params)
        return cur

    # -- entries ------------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        d, name = self._split(entry.full_path)
        with self._lock:
            self._exec(
                self._upsert_sql("filemeta", "dir, name, meta", 3),
                (d, name, json.dumps(entry.to_dict())),
            )
            self._db.commit()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry:
        d, name = self._split(path)
        with self._lock:
            row = self._exec(
                f"SELECT meta FROM filemeta WHERE dir={self._ph} AND name={self._ph}",
                (d, name),
            ).fetchone()
        if row is None:
            raise NotFoundError(path)
        return Entry.from_dict(json.loads(row[0]))

    def delete_entry(self, path: str) -> None:
        d, name = self._split(path)
        with self._lock:
            self._exec(
                f"DELETE FROM filemeta WHERE dir={self._ph} AND name={self._ph}",
                (d, name),
            )
            self._db.commit()

    def delete_folder_children(self, path: str) -> None:
        p = _norm(path)
        with self._lock:
            self._exec(f"DELETE FROM filemeta WHERE dir={self._ph}", (p,))
            self._exec(
                f"DELETE FROM filemeta WHERE dir LIKE {self._ph}",
                (p.rstrip("/") + "/%",),
            )
            self._db.commit()

    def list_entries(
        self, dir_path: str, start_after: str = "", limit: int = 1000
    ) -> Iterator[Entry]:
        d = _norm(dir_path)
        with self._lock:
            rows = self._exec(
                f"SELECT meta FROM filemeta WHERE dir={self._ph} "
                f"AND name>{self._ph} ORDER BY name LIMIT {self._ph}",
                (d, start_after, limit),
            ).fetchall()
        for (meta,) in rows:
            yield Entry.from_dict(json.loads(meta))

    # -- kv -----------------------------------------------------------------
    def kv_put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._exec(self._upsert_sql("kv", "k, v", 2), (key, value))
            self._db.commit()

    def kv_get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._exec(
                f"SELECT v FROM kv WHERE k={self._ph}", (key,)
            ).fetchone()
        return row[0] if row else None

    def kv_delete(self, key: bytes) -> None:
        with self._lock:
            self._exec(f"DELETE FROM kv WHERE k={self._ph}", (key,))
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()


class SqliteStore(AbstractSqlStore):
    """Embedded instance of the abstract store — the filer's default,
    standing in for the reference's leveldb default."""

    def __init__(self, db_path: str = ":memory:"):
        import sqlite3

        super().__init__(sqlite3.connect(db_path, check_same_thread=False))
