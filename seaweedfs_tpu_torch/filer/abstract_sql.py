"""Generic SQL FilerStore over any DB-API 2.0 connection: the port's copy
of the JAX package's ``filer/abstract_sql.py``.

Mirrors `weed/filer/abstract_sql/abstract_sql_store.go`: one `filemeta`
table keyed (dir, name) with the entry's JSON as its meta column, plus a
`kv` table for checkpoints and signatures. The concrete dialect supplies a
connection factory and its paramstyle; `SqliteStore` is the embedded
instance (the filer's default store), and any networked DB-API driver
(mysql/postgres-style `format` placeholders or `qmark`) plugs in through
`GenericSqlStore` without subclassing. Schema and statements are the JAX
package's, so one database serves either package's filer.
"""

from __future__ import annotations

import json
import threading
from typing import Iterator, Optional

from .entry import Entry
from .filerstore import FilerStore, NotFoundError, _norm

_PLACEHOLDER = {"qmark": "?", "format": "%s", "pyformat": "%s"}

# dialect → (filemeta DDL, kv DDL, upsert template). The schema follows
# abstract_sql_store.go: mysql needs sized key columns (no TEXT in a PK),
# postgres spells blobs BYTEA and upserts via ON CONFLICT.
_DIALECTS = {
    "sqlite": (
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dir TEXT NOT NULL, name TEXT NOT NULL, meta TEXT NOT NULL,"
        " PRIMARY KEY (dir, name))",
        "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)",
        "INSERT OR REPLACE INTO {table} ({cols}) VALUES ({ph})",
    ),
    "mysql": (
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dir VARCHAR(766) NOT NULL, name VARCHAR(250) NOT NULL,"
        " meta LONGTEXT NOT NULL, PRIMARY KEY (dir, name))",
        "CREATE TABLE IF NOT EXISTS kv"
        " (k VARBINARY(512) PRIMARY KEY, v LONGBLOB)",
        "REPLACE INTO {table} ({cols}) VALUES ({ph})",
    ),
    "postgres": (
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dir TEXT NOT NULL, name TEXT NOT NULL, meta TEXT NOT NULL,"
        " PRIMARY KEY (dir, name))",
        "CREATE TABLE IF NOT EXISTS kv (k BYTEA PRIMARY KEY, v BYTEA)",
        "INSERT INTO {table} ({cols}) VALUES ({ph})"
        " ON CONFLICT ({pk}) DO UPDATE SET {assign}",
    ),
}

_UPSERT_META = {  # per-table ON CONFLICT pieces for the postgres template
    "filemeta": ("dir, name", "meta = EXCLUDED.meta"),
    "kv": ("k", "v = EXCLUDED.v"),
}


def _guess_dialect(driver: str) -> str:
    d = driver.lower()
    if "mysql" in d or "maria" in d:
        return "mysql"
    if "psycopg" in d or d in ("pg8000", "pgdb"):
        return "postgres"
    return "sqlite"


class AbstractSqlStore(FilerStore):
    """All six FilerStore ops + KV expressed as dialect-parameterized SQL.

    Subclasses / callers provide `conn` (DB-API connection), `paramstyle`
    (qmark/format/pyformat), and `dialect` (sqlite/mysql/postgres) picking
    the DDL + upsert flavor.
    """

    def __init__(self, conn, paramstyle: str = "qmark", dialect: str = "sqlite"):
        if paramstyle not in _PLACEHOLDER:
            raise ValueError(
                f"unsupported DB-API paramstyle {paramstyle!r}; "
                f"supported: {sorted(_PLACEHOLDER)}"
            )
        if dialect not in _DIALECTS:
            raise ValueError(
                f"unsupported SQL dialect {dialect!r}; "
                f"supported: {sorted(_DIALECTS)}"
            )
        self._db = conn
        self._ph = _PLACEHOLDER[paramstyle]
        self._dialect = dialect
        self._lock = threading.RLock()
        self._create_tables()

    # -- dialect hooks ------------------------------------------------------
    def _create_tables(self) -> None:
        meta_ddl, kv_ddl, _ = _DIALECTS[self._dialect]
        with self._lock:
            cur = self._db.cursor()
            cur.execute(meta_ddl)
            cur.execute(kv_ddl)
            self._db.commit()

    def _upsert_sql(self, table: str, cols: str, nvals: int) -> str:
        pk, assign = _UPSERT_META[table]
        return _DIALECTS[self._dialect][2].format(
            table=table,
            cols=cols,
            ph=",".join([self._ph] * nvals),
            pk=pk,
            assign=assign,
        )

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

        super().__init__(
            sqlite3.connect(db_path, check_same_thread=False),
            paramstyle="qmark",
        )


class GenericSqlStore(AbstractSqlStore):
    """Adapter for external DB-API drivers selected by dotted module name.

    filer.toml:
        [sql]
        enabled = true
        driver = "pymysql"            # any DB-API module on sys.path
        # dialect = "mysql"           # optional; guessed from the driver
        # connect kwargs passed through (host/port/user/password/database…)
    """

    def __init__(self, driver: str, dialect: str = "", **connect_kwargs):
        import importlib

        mod = importlib.import_module(driver)
        conn = mod.connect(**connect_kwargs)
        super().__init__(
            conn,
            paramstyle=getattr(mod, "paramstyle", "qmark"),
            dialect=dialect or _guess_dialect(driver),
        )
