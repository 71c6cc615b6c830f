"""The port's filer stores held against the JAX package's: ``MemoryStore``,
``SqliteStore``, ``RedisStore`` over the in-repo ``MiniRedisServer`` and
``GenericSqlStore("sqlite3")``.

The reference's FilerStore contract (``tests/test_filerstore_adapters.py``:
CRUD, listing with ``start_after`` and ``limit``, the recursive folder wipe,
deep paging, KV) runs on each port store. A seeded sequence of inserts,
updates, deletes and KV writes goes through a port store and the JAX store of
the same kind, and every listing and KV read is equal. Each package's
``RespClient`` works against the other package's ``MiniRedisServer``, and a
port ``RedisStore`` reads what a JAX one wrote. The SQL statements each
dialect emits (sqlite, mysql, postgres; qmark and format placeholders) are
the JAX package's, statement for statement. The SDK stores (cassandra,
mongodb, etcd, elastic) fail with an ImportError naming their package. Two
port filers over one redis serve each other's writes.
"""

import socket
import sqlite3
import time

import numpy as np
import pytest

from seaweedfs_tpu.filer import abstract_sql as jsql
from seaweedfs_tpu.filer import entry as jentry
from seaweedfs_tpu.filer import filerstore as jstore
from seaweedfs_tpu.filer import redis_store as jredis
from seaweedfs_tpu.filer import sdk_stores as jsdk
from seaweedfs_tpu.util import mini_redis as jmini
from seaweedfs_tpu_torch.filer import abstract_sql as psql
from seaweedfs_tpu_torch.filer import entry as pentry
from seaweedfs_tpu_torch.filer import filerstore as pstore
from seaweedfs_tpu_torch.filer import redis_store as predis
from seaweedfs_tpu_torch.filer import sdk_stores as psdk
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filerstore import NotFoundError
from seaweedfs_tpu_torch.util import mini_redis as pmini

KINDS = ("memory", "sqlite", "redis", "generic-sql")


@pytest.fixture(scope="module")
def redis_servers():
    """One mini redis of each package."""
    srv = {"port": pmini.MiniRedisServer().start(), "jax": jmini.MiniRedisServer().start()}
    yield srv
    for s in srv.values():
        s.stop()


def _make(pkg: str, kind: str, redis_addr: str):
    store, sql, redis = ((pstore, psql, predis) if pkg == "port"
                         else (jstore, jsql, jredis))
    if kind == "memory":
        return store.MemoryStore()
    if kind == "sqlite":
        return sql.SqliteStore()
    if kind == "generic-sql":
        return sql.GenericSqlStore("sqlite3", database=":memory:", check_same_thread=False)
    s = redis.RedisStore(redis_addr)
    s._client.execute("FLUSHDB")
    return s


@pytest.fixture(params=KINDS)
def store(request, redis_servers):
    s = _make("port", request.param, redis_servers["port"].address)
    yield s
    s.close()


# -- the reference's contract, on each port store ------------------------------
def test_contract_crud_listing_kv(store):
    store.insert_entry(Entry(full_path="/d", is_directory=True))
    for name in ("b.txt", "a.txt", "c.txt"):
        store.insert_entry(Entry(full_path=f"/d/{name}"))
    store.insert_entry(Entry(full_path="/d/sub", is_directory=True))
    store.insert_entry(Entry(full_path="/d/sub/deep.txt"))
    assert store.find_entry("/d/a.txt").name == "a.txt"
    assert [e.name for e in store.list_entries("/d")] == ["a.txt", "b.txt", "c.txt", "sub"]
    assert [e.name for e in store.list_entries("/d", start_after="b.txt")] == ["c.txt", "sub"]
    assert [e.name for e in store.list_entries("/d", limit=2)] == ["a.txt", "b.txt"]
    e = store.find_entry("/d/a.txt")
    e.mime = "text/plain"
    store.update_entry(e)
    assert store.find_entry("/d/a.txt").mime == "text/plain"
    store.delete_entry("/d/a.txt")
    with pytest.raises(NotFoundError):
        store.find_entry("/d/a.txt")
    store.delete_folder_children("/d")
    assert list(store.list_entries("/d")) == []
    with pytest.raises(NotFoundError):
        store.find_entry("/d/sub/deep.txt")
    store.kv_put(b"offset", b"\x00\x01\x02")
    assert store.kv_get(b"offset") == b"\x00\x01\x02"
    assert store.kv_get(b"missing") is None
    store.kv_delete(b"offset")
    assert store.kv_get(b"offset") is None
    store.kv_delete(b"missing")


def test_contract_deep_paging(store):
    store.insert_entry(Entry(full_path="/big", is_directory=True))
    names = [f"f{i:04d}" for i in range(250)]
    for n in names:
        store.insert_entry(Entry(full_path=f"/big/{n}"))
    got, after = [], ""
    while True:
        page = [e.name for e in store.list_entries("/big", start_after=after, limit=100)]
        if not page:
            break
        got += page
        after = page[-1]
    assert got == names


# -- the same seeded operations on both packages' stores -----------------------
def _script(seed: int) -> list:
    """A seeded list of store operations over a small tree."""
    rng = np.random.default_rng(seed)
    dirs = ["/", "/a", "/a/b", "/c", "/c/d e"]
    ops = [("mkdir", d) for d in dirs[1:]]
    for i in range(160):
        r = rng.random()
        d = dirs[int(rng.integers(len(dirs)))]
        name = f"n{int(rng.integers(60)):02d}"
        path = f"{d.rstrip('/')}/{name}"
        if r < 0.55:
            ops.append(("put", path, {"mime": f"m/{i}", "mode": int(rng.integers(0o777)),
                                      "chunks": [{"file_id": f"3,{i:x}aa", "offset": 0,
                                                  "size": int(rng.integers(1, 9999))}]}))
        elif r < 0.7:
            ops.append(("delete", path))
        elif r < 0.85:
            ops.append(("kv_put", f"k{int(rng.integers(20))}".encode(), rng.bytes(8)))
        else:
            ops.append(("kv_delete", f"k{int(rng.integers(20))}".encode()))
    ops.append(("wipe", "/c/d e"))
    return ops


def _apply(pkg: str, store, ops) -> dict:
    E = pentry.Entry if pkg == "port" else jentry.Entry
    for op in ops:
        if op[0] == "mkdir":
            store.insert_entry(E(full_path=op[1], is_directory=True, mtime=1, crtime=1))
        elif op[0] == "put":
            store.insert_entry(E.from_dict({"full_path": op[1], "mtime": 2, "crtime": 2,
                                            **op[2]}))
        elif op[0] == "delete":
            store.delete_entry(op[1])
        elif op[0] == "kv_put":
            store.kv_put(op[1], op[2])
        elif op[0] == "kv_delete":
            store.kv_delete(op[1])
        elif op[0] == "wipe":
            store.delete_folder_children(op[1])
    out = {}
    for d in ("/", "/a", "/a/b", "/c", "/c/d e"):
        pages, after = [], ""
        while True:
            page = [e.to_dict() for e in store.list_entries(d, start_after=after, limit=7)]
            if not page:
                break
            pages.append(page)
            after = page[-1]["full_path"].rsplit("/", 1)[1]
        out[d] = pages
    out["kv"] = {k: store.kv_get(f"k{k}".encode()) for k in range(20)}
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_same_operations_give_equal_listings(kind, redis_servers):
    ops = _script(seed=KINDS.index(kind))
    p = _make("port", kind, redis_servers["port"].address)
    j = _make("jax", kind, redis_servers["jax"].address)
    try:
        got, want = _apply("port", p, ops), _apply("jax", j, ops)
        assert got == want
        assert sum(len(pg) for pages in list(got.values())[:5] for pg in pages) > 20
    finally:
        p.close()
        j.close()


# -- RESP across the packages ---------------------------------------------------
@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "jax"), ("jax", "port")])
def test_resp_client_against_the_other_server(redis_servers, client_pkg, server_pkg):
    mod = predis if client_pkg == "port" else jredis
    c = mod.RespClient(redis_servers[server_pkg].address)
    c.execute("FLUSHDB")
    assert c.execute("PING") == "PONG"
    c.execute("SET", b"bin\x00key", b"bin\x01value")
    assert c.execute("GET", b"bin\x00key") == b"bin\x01value"
    assert c.execute("GET", "nope") is None
    assert c.execute("DEL", b"bin\x00key") == 1
    c.execute("ZADD", "z", 0, "alpha", 0, "beta", 0, "gamma")
    assert c.execute("ZRANGEBYLEX", "z", b"(alpha", b"+", "LIMIT", 0, 10) == [b"beta", b"gamma"]
    assert c.execute("ZRANGE", "z", 0, -1) == [b"alpha", b"beta", b"gamma"]
    with pytest.raises(mod.RespError):
        c.execute("NOSUCHCMD")
    c.close()


def test_resp_bytes_equal_jax():
    """Both clients put the same commands on the wire, and both servers
    answer with the same bytes."""
    cmds = [("SET", b"bin\x00key", b"v\r\n", "EX", 5), ("ZADD", "z", 0, "m", 1.5, "n"),
            ("ZRANGEBYLEX", "z", b"(a", b"+", "LIMIT", 0, -1), ("GET", ""), ("PING",)]
    for c in cmds:
        assert predis.RespClient._enc(c) == jredis.RespClient._enc(c)
    replies = [None, 0, 7, -1, True, b"", b"x\r\ny", "text", [b"a", [1, None]],
               pmini.OK, pmini.PONG, pmini.Error("ERR nope")]
    jmap = {id(pmini.OK): jmini.OK, id(pmini.PONG): jmini.PONG}
    for r in replies:
        j = jmap.get(id(r), jmini.Error(r.s) if isinstance(r, pmini.Error) else r)
        assert pmini._encode(r) == jmini._encode(j), r


def test_port_redis_store_reads_what_jax_wrote(redis_servers):
    addr = redis_servers["port"].address
    j = jredis.RedisStore(addr)
    j._client.execute("FLUSHDB")
    j.insert_entry(jentry.Entry(full_path="/x", is_directory=True))
    j.insert_entry(jentry.Entry.from_dict({"full_path": "/x/f.bin", "mime": "a/b",
                                           "chunks": [{"file_id": "1,2", "size": 3}]}))
    j.kv_put(b"repl.applied.1", b"1")
    p = predis.RedisStore(addr)
    assert p.find_entry("/x/f.bin").to_dict() == j.find_entry("/x/f.bin").to_dict()
    assert [e.name for e in p.list_entries("/x")] == ["f.bin"]
    assert p.kv_get(b"repl.applied.1") == b"1"
    p.close()
    j.close()


def test_resp_auth_and_bare_hostname(monkeypatch):
    srv = pmini.MiniRedisServer(password="sekret").start()
    try:
        with pytest.raises(predis.RespError):
            predis.RespClient(srv.address).execute("GET", "x")
        assert predis.RespClient(srv.address, password="sekret").execute("PING") == "PONG"
        with pytest.raises(predis.RespError):
            predis.RespClient(srv.address, password="wrong")
    finally:
        srv.stop()
    seen = {}

    def fake_connect(addr, timeout=None):
        seen["addr"] = addr
        raise ConnectionRefusedError

    monkeypatch.setattr(socket, "create_connection", fake_connect)
    with pytest.raises(ConnectionRefusedError):
        predis.RespClient("somehost")
    assert seen["addr"] == ("somehost", 6379)


def test_redis_entry_ttl(redis_servers):
    s = predis.RedisStore(redis_servers["port"].address)
    s._client.execute("FLUSHDB")
    s.insert_entry(Entry(full_path="/t", is_directory=True))
    e = Entry(full_path="/t/tmp.txt")
    e.ttl_sec = 1
    s.insert_entry(e)
    assert s.find_entry("/t/tmp.txt").name == "tmp.txt"
    time.sleep(1.2)
    with pytest.raises(NotFoundError):
        s.find_entry("/t/tmp.txt")
    assert [x.name for x in s.list_entries("/t")] == []


# -- SQL statements per dialect ---------------------------------------------------
class _Recorder:
    """A DB-API connection that records every statement and runs it on an
    in-memory sqlite, translated, so the store still works."""

    def __init__(self, paramstyle: str):
        self.paramstyle = paramstyle
        self.sql = []
        self._db = sqlite3.connect(":memory:", check_same_thread=False)

    def cursor(self):
        rec = self

        class _Cur:
            def execute(self, sql, params=()):
                rec.sql.append(sql)
                s = sql.replace("%s", "?")
                if s.startswith("REPLACE INTO"):  # mysql's upsert → sqlite's
                    s = "INSERT OR " + s
                s = (s.replace("LONGTEXT", "TEXT").replace("VARBINARY(512)", "BLOB")
                     .replace("LONGBLOB", "BLOB").replace("VARCHAR(766)", "TEXT")
                     .replace("VARCHAR(250)", "TEXT").replace("BYTEA", "BLOB"))
                if "ON CONFLICT" in s:  # postgres upsert → sqlite's
                    s = s.split(" ON CONFLICT")[0].replace("INSERT INTO",
                                                           "INSERT OR REPLACE INTO")
                self._c = rec._db.execute(s, params)
                return self._c

            def fetchone(self):
                return self._c.fetchone()

            def fetchall(self):
                return self._c.fetchall()

        return _Cur()

    def commit(self):
        self._db.commit()

    def close(self):
        self._db.close()


@pytest.mark.parametrize("dialect,paramstyle", [("sqlite", "qmark"), ("mysql", "format"),
                                                ("postgres", "format"),
                                                ("postgres", "pyformat")])
def test_sql_statements_equal_jax(dialect, paramstyle):
    ops = _script(seed=7)[:60]
    logs = {}
    for pkg, sql_mod in (("port", psql), ("jax", jsql)):
        rec = _Recorder(paramstyle)
        s = sql_mod.AbstractSqlStore(rec, paramstyle=paramstyle, dialect=dialect)
        listing = _apply(pkg, s, ops)
        logs[pkg] = (rec.sql, listing)
    assert logs["port"] == logs["jax"]
    stmts = logs["port"][0]
    if dialect == "mysql":
        assert any(x.startswith("REPLACE INTO filemeta") for x in stmts)
    if dialect == "postgres":
        assert any("ON CONFLICT (dir, name) DO UPDATE SET meta = EXCLUDED.meta" in x
                   for x in stmts)
    assert psql._DIALECTS == jsql._DIALECTS and psql._PLACEHOLDER == jsql._PLACEHOLDER


def test_dialect_guess_and_refusals():
    for driver in ("pymysql", "MySQLdb", "mariadb", "psycopg2", "pg8000", "pgdb", "sqlite3",
                   "oracledb"):
        assert psql._guess_dialect(driver) == jsql._guess_dialect(driver)
    assert psql._guess_dialect("pymysql") == "mysql"
    assert psql._guess_dialect("psycopg2") == "postgres"
    with pytest.raises(ValueError, match="paramstyle"):
        psql.AbstractSqlStore(_Recorder("named"), paramstyle="named")
    with pytest.raises(ValueError, match="dialect"):
        psql.AbstractSqlStore(_Recorder("qmark"), dialect="oracle")


# -- the SDK stores ------------------------------------------------------------------
SDK = [("CassandraStore", {"hosts": ["h"]}, "cassandra"), ("MongoStore", {}, "pymongo"),
       ("EtcdStore", {}, "etcd3"), ("ElasticStore", {"servers": ["http://h:9200"]},
                                     "elasticsearch")]


@pytest.mark.parametrize("name,kwargs,sdk", SDK, ids=[s[0] for s in SDK])
def test_sdk_store_gates_loudly(name, kwargs, sdk):
    try:
        __import__(sdk)
        pytest.skip(f"{sdk} is installed: the gate is not reachable")
    except ImportError:
        pass
    with pytest.raises(ImportError) as got:
        getattr(psdk, name)(**kwargs)
    with pytest.raises(ImportError) as want:
        getattr(jsdk, name)(**kwargs)
    assert str(got.value) == str(want.value)
    assert "package" in str(got.value) and "store" in str(got.value)


def test_sdk_store_layout_equals_jax():
    for path in ("/a/b/c.txt", "/top.txt", "/", "/a/b/"):
        assert psdk._split(path) == jsdk._split(path)
    e = Entry(full_path="/x/y.bin", mode=0o640, uid=7, gid=8)
    assert psdk._ser(e) == jsdk._ser(jentry.Entry(full_path="/x/y.bin", mode=0o640, uid=7,
                                                  gid=8))
    back = psdk._deser("/x/y.bin", psdk._ser(e))
    assert (back.full_path, back.mode, back.uid, back.gid) == ("/x/y.bin", 0o640, 7, 8)


# -- two port filers over one redis -------------------------------------------------
def test_two_filers_share_redis_store(redis_servers, tmp_path):
    from seaweedfs_tpu_torch.server.filer_server import FilerServer
    from seaweedfs_tpu_torch.server.http_util import http_bytes
    from seaweedfs_tpu_torch.server.master_server import MasterServer
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    master = MasterServer(port=free_port(), node_timeout=60).start()
    volume = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                          max_volume_count=10, pulse_seconds=0.5, ec_backend="cpu").start()
    addr = redis_servers["port"].address
    sa = predis.RedisStore(addr)
    sa._client.execute("FLUSHDB")
    fa = FilerServer(port=free_port(), master_url=master.url, store=sa,
                     meta_log_dir=str(tmp_path / "mlA"), query_backend="cpu").start()
    fb = FilerServer(port=free_port(), master_url=master.url, store=predis.RedisStore(addr),
                     meta_log_dir=str(tmp_path / "mlB"), query_backend="cpu").start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not master.master.topo.data_nodes():
            time.sleep(0.05)
        assert http_bytes("POST", f"http://{fa.url}/shared/hello.txt", b"written via A")[0] \
            in (200, 201)
        assert http_bytes("GET", f"http://{fb.url}/shared/hello.txt") == (200, b"written via A")
        assert http_bytes("DELETE", f"http://{fb.url}/shared/hello.txt")[0] < 300
        assert http_bytes("GET", f"http://{fa.url}/shared/hello.txt")[0] == 404
        assert fa.signature == fb.signature  # persisted in the shared store
    finally:
        fb.stop()
        fa.stop()
        volume.stop()
        master.stop()
