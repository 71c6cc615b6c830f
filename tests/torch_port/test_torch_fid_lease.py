"""Fid-range leases of the port (``cluster/fid_lease.py``, the master's
``/dir/fid_lease``), held against the JAX package's.

The cases of the JAX package's ``tests/test_fid_lease.py`` run on both
packages: grant, renew, expiry, the durable journal and its crash replay
(no fid issued twice across a restart), and the client side's local
minting. A journal written by one package is replayed by the other. On a
port master with ``meta_dir``, a lease granted over HTTP survives the
master's restart: the restarted master issues no key of the leased range.
"""

import json
import socket
import time

import pytest

import seaweedfs_tpu.cluster.fid_lease as j_fl
import seaweedfs_tpu_torch.cluster.fid_lease as p_fl
from seaweedfs_tpu.storage.file_id import FileId as JFileId
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId

MODS = {"jax": j_fl, "port": p_fl}


@pytest.fixture(params=list(MODS))
def fl(request):
    return MODS[request.param]


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the manager ---------------------------------------------------------------

def test_register_returns_lease_and_counts(fl, tmp_path):
    m = fl.FidLeaseManager(str(tmp_path / "leases.jsonl"))
    reg = m.register("filer-a", vid=3, key=100, count=64)
    assert reg["lease_id"] == "L1-100" and reg["expires"] > 0
    st = m.stats()
    assert st["granted"] == 1 and st["live"] == 1
    m.close()


def test_renew_extends_live_lease(fl, tmp_path):
    m = fl.FidLeaseManager(str(tmp_path / "leases.jsonl"))
    reg = m.register("filer-a", vid=1, key=10, count=8, ttl_s=30)
    exp2 = m.renew(reg["lease_id"], ttl_s=60)
    assert exp2 is not None and exp2 > reg["expires"]
    assert m.stats()["renewed"] == 1
    m.close()


def test_renew_unknown_or_expired_returns_none(fl, tmp_path):
    m = fl.FidLeaseManager(str(tmp_path / "leases.jsonl"))
    assert m.renew("L999-0") is None
    reg = m.register("filer-a", vid=1, key=10, count=8, ttl_s=0.001)
    time.sleep(0.01)
    assert m.renew(reg["lease_id"]) is None
    m.close()


def test_expire_stale_drops_from_live_table_only(fl, tmp_path):
    path = str(tmp_path / "leases.jsonl")
    m = fl.FidLeaseManager(path)
    m.register("filer-a", vid=1, key=10, count=8, ttl_s=0.001)
    m.register("filer-b", vid=1, key=18, count=8, ttl_s=60)
    time.sleep(0.01)
    assert m.expire_stale() == 1
    st = m.stats()
    assert st["live"] == 1 and st["expired"] == 1
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    assert sum(r["op"] == "grant" for r in recs) == 2  # the expired range stays burned
    m.close()


def test_journal_is_durable_before_response(fl, tmp_path):
    path = str(tmp_path / "leases.jsonl")
    m = fl.FidLeaseManager(path)
    m.register("filer-a", vid=7, key=500, count=128)
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    assert recs and recs[0]["op"] == "grant"
    assert (recs[0]["key"], recs[0]["count"], recs[0]["vid"]) == (500, 128, 7)
    m.close()


def test_no_journal_path_disables_persistence(fl):
    m = fl.FidLeaseManager(None)
    assert m.register("filer-a", vid=1, key=1, count=4)["lease_id"]
    assert m.replay(lambda _high: pytest.fail("no journal to replay")) == 0
    m.close()


def test_replay_skips_torn_tail(fl, tmp_path):
    path = str(tmp_path / "leases.jsonl")
    m = fl.FidLeaseManager(path)
    m.register("filer-a", vid=1, key=100, count=64)
    m.close()
    with open(path, "a") as f:
        f.write('{"op": "grant", "key": 999, "cou')  # a crash mid-append
    m2 = fl.FidLeaseManager(path)
    assert m2.replay(lambda h: None) == 164
    m2.close()


class Seq:
    def __init__(self):
        self.next_key = 1

    def take(self, n):
        base = self.next_key
        self.next_key += n
        return base

    def set_max(self, high):
        self.next_key = max(self.next_key, high)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_crash_replay_no_fid_double_issued(tmp_path, writer, reader):
    """Grants journaled by one package, a "crash", and a restart on the
    other: replay protects every granted range, and the restarted side
    issues no key of them."""
    path = str(tmp_path / "fid_leases_9333.jsonl")
    seq1, m1 = Seq(), MODS[writer].FidLeaseManager(path)
    issued = set()
    for client in ("f1", "f2", "f3"):
        base = seq1.take(32)
        m1.register(client, vid=1, key=base, count=32)
        issued.update(range(base, base + 32))
    seen = []
    seq2, m2 = Seq(), MODS[reader].FidLeaseManager(path)
    high = m2.replay(lambda h: (seen.append(h), seq2.set_max(h)))
    assert high == seen[0] == 97 and m2.stats()["replayed_max_key"] == 97
    base = seq2.take(32)
    m2.register("f4", vid=1, key=base, count=32)
    assert not set(range(base, base + 32)) & issued
    m2.close()
    m1.close()


# -- the client side -----------------------------------------------------------

def _grant_ok(fl, count, base_key=100):
    FID = FileId if fl is p_fl else JFileId
    return {"fid": str(FID(3, base_key, 0xABCD)), "url": "127.0.0.1:9000",
            "publicUrl": "127.0.0.1:9000", "count": count, "lease_id": f"L1-{base_key}",
            "expires": time.time() + 30}


def _fallback_fail(*a):
    raise AssertionError("fallback must not be used while the lease serves")


def test_leased_source_mints_locally(fl, monkeypatch):
    monkeypatch.setenv("SWEED_FID_LEASE", "1")
    calls = []

    def grant(collection, replication, ttl, count):
        calls.append(count)
        return _grant_ok(fl, count)

    src = fl.LeasedFidSource(grant, _fallback_fail)
    fids = [src.assign("", "", "").fid for _ in range(10)]
    assert fids == [str(FileId(3, 100 + i, 0xABCD)) for i in range(10)]
    assert len(calls) == 1
    assert src.stats() == {"minted": 10, "leases": 1, "fallbacks": 0, "active_ranges": 1}


def test_leased_source_releases_when_range_dry(fl, monkeypatch):
    monkeypatch.setenv("SWEED_FID_LEASE", "1")
    monkeypatch.setenv("SWEED_FID_LEASE_COUNT", "4")
    calls = []

    def grant(collection, replication, ttl, count):
        calls.append(count)
        return _grant_ok(fl, count, base_key=100 + 10 * len(calls))

    src = fl.LeasedFidSource(grant, _fallback_fail)
    assert len({src.assign("", "", "").fid for _ in range(9)}) == 9
    assert calls == [4, 4, 4]


def test_leased_source_falls_back(fl, monkeypatch):
    """Grant failure, leasing off, and an auth cluster without a signing key
    all take the per-request path."""
    sentinel = object()
    monkeypatch.setenv("SWEED_FID_LEASE", "1")

    def down(*a):
        raise ConnectionError("master down")

    src = fl.LeasedFidSource(down, lambda *a: sentinel)
    assert src.assign("", "", "") is sentinel and src.stats()["fallbacks"] == 1
    authed = fl.LeasedFidSource(lambda *a: {**_grant_ok(fl, a[3]), "auth": "jwt"},
                                lambda *a: sentinel, sign_fn=None)
    assert authed.assign("", "", "") is sentinel
    monkeypatch.setenv("SWEED_FID_LEASE", "0")
    assert fl.LeasedFidSource(lambda *a: _grant_ok(fl, a[3]),
                              lambda *a: sentinel).assign("", "", "") is sentinel


@pytest.mark.parametrize("env,want", [({}, (30.0, 128)),
                                      ({"SWEED_FID_LEASE_S": "2.5",
                                        "SWEED_FID_LEASE_COUNT": "7"}, (2.5, 7)),
                                      ({"SWEED_FID_LEASE_S": "junk",
                                        "SWEED_FID_LEASE_COUNT": "-3"}, (30.0, 128))])
def test_env_knobs(monkeypatch, env, want):
    for k in ("SWEED_FID_LEASE_S", "SWEED_FID_LEASE_COUNT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fl in MODS.values():
        assert (fl.lease_seconds(), fl.lease_count()) == want


# -- the master ----------------------------------------------------------------

def _start_master(port, meta):
    deadline = time.time() + 10
    while True:  # a restart may race the old socket out of the port
        try:
            return MasterServer(port=port, node_timeout=60, meta_dir=meta).start()
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


def test_master_lease_survives_restart(tmp_path, monkeypatch):
    """``/dir/fid_lease`` on a port master with ``meta_dir``: the client
    mints fids of the granted range locally and writes them; after the
    master restarts, its assigns start past the whole range."""
    monkeypatch.setenv("SWEED_FID_LEASE", "1")
    port, meta = free_port(), str(tmp_path / "meta")
    master = _start_master(port, meta)
    vs = VolumeServer([str(tmp_path / "v")], port=free_port(), master_url=master.url,
                      pulse_seconds=0.3, ec_backend="cpu").start()
    try:
        deadline = time.time() + 10
        while not master.master.topo.data_nodes() and time.time() < deadline:
            time.sleep(0.05)

        def grant(collection, replication, ttl, count):
            return http_json("POST", f"http://{master.url}/dir/fid_lease?client=t&count={count}"
                                     f"&collection={collection}")

        src = p_fl.LeasedFidSource(grant, _fallback_fail)
        minted = [src.assign("", "", "") for _ in range(5)]
        for i, a in enumerate(minted):
            assert http_bytes("POST", f"http://{a.url}/{a.fid}", b"leased %d" % i)[0] == 201
        keys = [FileId.parse(a.fid).key for a in minted]
        assert keys == list(range(keys[0], keys[0] + 5))
        st = http_json("GET", f"http://{master.url}/dir/status")["fid_leases"]
        assert st["granted"] == 1 and st["live"] == 1
        master.stop()
        master = _start_master(port, meta)
        assert master.fid_leases.stats()["replayed_max_key"] == keys[0] + 128
        deadline = time.time() + 10
        while not master.master.topo.data_nodes() and time.time() < deadline:
            time.sleep(0.05)
        # GET: the pooled socket from before the restart is retried once
        a = http_json("GET", f"http://{master.url}/dir/assign")
        assert FileId.parse(a["fid"]).key >= keys[0] + 128
        for i, m in enumerate(minted):
            assert http_bytes("GET", f"http://{m.url}/{m.fid}") == (200, b"leased %d" % i)
    finally:
        vs.stop()
        master.stop()
