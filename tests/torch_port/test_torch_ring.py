"""The port's sharded filer fleet (``filer/ring.py``, ``messaging/consistent.py``
and the ring gates of ``server/filer_server.py``) held against the JAX
package's.

Placement is the contract between the packages: on 10 000 seeded paths over
member sets of one to five filers, ``shard_key``, ``FilerRing.owner``/``owns``
and ``ConsistentRing.get`` of the port equal the JAX package's. The
reference's ``tests/test_consistent_ring.py`` corner cases run on the port's
ring. The reference's ``tests/test_meta_shard.py`` scenarios run on a fleet
of two port filers over a port master and volume server: routing through
``RingFilerClient``, a plain client following the 307, the raw 307 with its
``Location``, a proxied write, the merged spine listing, a delete through
the wrong filer and fid leases; ``make_client`` and the S3 gateway front the
fleet with a comma list. A mixed ring of one JAX and one port filer serves
the same writes as an all-JAX ring on the same addresses, with equal
``tree_hash`` on each member.
"""

import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.filer import reshard as jreshard
from seaweedfs_tpu.filer import ring as jring
from seaweedfs_tpu.messaging import consistent as jconsistent
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu_torch.filer import reshard as preshard
from seaweedfs_tpu_torch.filer import ring as pring
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.messaging import consistent as pconsistent
from seaweedfs_tpu_torch.messaging.consistent import ConsistentRing
from seaweedfs_tpu_torch.server.filer_server import FilerServer as PFilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def seeded_paths(n: int, seed: int) -> list:
    """Paths of 1-5 segments over a small alphabet, so shard keys repeat."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = int(rng.integers(1, 6))
        segs = [f"{'abcdefgh'[int(rng.integers(8))]}{int(rng.integers(40))}"
                for _ in range(depth)]
        out.append("/" + "/".join(segs) + ("/" if rng.random() < 0.1 else ""))
    return out


MEMBERS = [f"10.0.0.{i}:{8888 + i}" for i in range(1, 6)]


# -- placement: the port against the JAX package -------------------------------
@pytest.mark.parametrize("n_members", [1, 2, 3, 4, 5])
def test_shard_key_and_owner_equal_jax(n_members):
    paths = seeded_paths(10_000, seed=n_members)
    members = MEMBERS[:n_members]
    for depth in (1, 2, 3):
        assert [pring.shard_key(p, depth) for p in paths] == \
            [jring.shard_key(p, depth) for p in paths]
    pr = pring.FilerRing(members, self_url=members[0])
    jr = jring.FilerRing(members, self_url=members[0])
    assert pr.plan() == jr.plan()
    assert [pr.owner(p) for p in paths] == [jr.owner(p) for p in paths]
    assert [pr.owns(p) for p in paths] == [jr.owns(p) for p in paths]
    assert [pr.is_spine(p) for p in paths] == [jr.is_spine(p) for p in paths]
    if n_members > 1:  # the keys spread over every member
        assert {pr.owner(p) for p in paths} == set(members)


@pytest.mark.parametrize("n_members", [1, 2, 3, 4, 5])
def test_consistent_ring_placement_equal(n_members):
    keys = [f"/b/{k}" for k in seeded_paths(2_000, seed=100 + n_members)]
    p, j = pconsistent.ConsistentRing(), jconsistent.ConsistentRing()
    for m in MEMBERS[:n_members]:
        p.add(m)
    for m in reversed(MEMBERS[:n_members]):  # join order does not matter
        j.add(m)
    assert p.members() == j.members()
    assert [p.get(k) for k in keys] == [j.get(k) for k in keys]
    assert pconsistent._hash("x") == jconsistent._hash("x")
    assert pconsistent._hash(b"/b/c") == jconsistent._hash(b"/b/c")


@pytest.mark.parametrize("raw,want", [("", 2), ("3", 3), ("0", 2), ("x", 2), ("1", 1)])
def test_ring_depth_env(monkeypatch, raw, want):
    monkeypatch.setenv("SWEED_RING_DEPTH", raw)
    assert pring.ring_depth() == jring.ring_depth() == want


# -- the reference's test_consistent_ring.py corner cases, on the port ---------
def test_empty_ring_raises():
    with pytest.raises(LookupError):
        ConsistentRing().get("anything")


def test_single_member_owns_everything():
    ring = ConsistentRing()
    ring.add("only:1")
    assert all(ring.get(f"k{i}") == "only:1" for i in range(50))


def test_duplicate_add_and_unknown_remove():
    ring = ConsistentRing()
    ring.add("a:1")
    before = [ring.get(f"k{i}") for i in range(20)]
    ring.add("a:1")
    ring.remove("ghost:9")
    assert len(ring) == 1 and "a:1" in ring and "b:2" not in ring
    assert [ring.get(f"k{i}") for i in range(20)] == before


def test_readd_restores_and_remove_moves_only_its_keys():
    keys = [f"/tenant/{i}" for i in range(500)]
    ring = ConsistentRing()
    for m in ("f1:1", "f2:2", "f3:3", "f4:4"):
        ring.add(m)
    before = {k: ring.get(k) for k in keys}
    ring.remove("f3:3")
    for k in keys:
        assert ring.get(k) != "f3:3"
        if before[k] != "f3:3":
            assert ring.get(k) == before[k]
    ring.add("f3:3")
    assert {k: ring.get(k) for k in keys} == before


def test_replicas_clamped_and_distribution_even():
    ring = ConsistentRing(replicas=0)
    ring.add("a:1")
    assert ring.get("k") == "a:1"
    ring = ConsistentRing(replicas=50)
    members = [f"f{i}:{i}" for i in range(4)]
    for m in members:
        ring.add(m)
    counts = {m: 0 for m in members}
    for i in range(4000):
        counts[ring.get(f"/bucket/prefix{i}")] += 1
    assert all(0.3 * 1000 < c < 2.5 * 1000 for c in counts.values()), counts


def test_cross_member_virtual_node_collisions_survive(monkeypatch):
    orig = pconsistent._hash

    def colliding(key):
        s = key if isinstance(key, str) else key.decode()
        return 42 if s.startswith(("m1#", "m2#")) else orig(key)

    monkeypatch.setattr(pconsistent, "_hash", colliding)
    ring = ConsistentRing()
    for m in ("m1", "m2", "m3"):
        ring.add(m)
    assert "m3" in {ring.get(f"k{i}") for i in range(300)}
    first = ring.get("fixed-key")
    assert all(ring.get("fixed-key") == first for _ in range(10))
    m3_keys = [f"k{i}" for i in range(300) if ring.get(f"k{i}") == "m3"]
    ring.remove("m1")
    assert all(ring.get(k) == "m3" for k in m3_keys)


# -- a fleet of two port filers: test_meta_shard.py's scenarios ----------------
@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ringplane")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volume = VolumeServer([str(tmp / "vol")], port=free_port(), master_url=master.url,
                          max_volume_count=20, pulse_seconds=0.5, ec_backend="cpu").start()
    deadline = time.time() + 10
    while time.time() < deadline and not master.master.topo.data_nodes():
        time.sleep(0.05)
    yield master, volume, tmp
    volume.stop()
    master.stop()


@pytest.fixture(scope="module")
def fleet(plane):
    master, volume, tmp = plane
    p1, p2 = free_port(), free_port()
    ring = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    filers = [PFilerServer(port=p, master_url=master.url, chunk_size=64 * 1024,
                           db_path=str(tmp / f"filer{i}.db"), ring_peers=ring,
                           query_backend="cpu").start()
              for i, p in enumerate((p1, p2))]
    time.sleep(0.3)
    yield master, volume, filers, ring
    for f in filers:
        f.stop()


def _owner_of(ring_members, path):
    return pring.FilerRing(ring_members, self_url=ring_members[0]).owner(path)


def _covering(ring_members, candidates, n):
    """The first ``n`` candidates, with the last ones swapped for others so
    that every member owns at least one (the ports, and so the placement,
    change from run to run)."""
    chosen = list(candidates[:n])
    for m in ring_members:
        if all(_owner_of(ring_members, c) != m for c in chosen):
            extra = next(c for c in candidates[n:] if _owner_of(ring_members, c) == m)
            victim = next(c for c in reversed(chosen)
                          if sum(_owner_of(ring_members, x) == _owner_of(ring_members, c)
                                 for x in chosen) > 1)
            chosen[chosen.index(victim)] = extra
    return chosen


def test_ring_endpoint_reports_fleet(fleet):
    _, _, filers, ring = fleet
    for f in filers:
        st = http_json("GET", f"http://{f.url}/_ring")
        assert st["ring"] == {"depth": 2, "members": sorted(ring), "self": f.url,
                              "active": True}
        assert "hedge" in st and "deadline" in st and "fid_leases" in st
        assert http_json("GET", f"http://{f.url}/_status")["ring"] == st["ring"]


def test_make_client_picks_by_address_count(fleet):
    _, _, filers, ring = fleet
    assert type(pring.make_client(ring[0])) is FilerClient
    assert type(pring.make_client([ring[0]])) is FilerClient
    rc = pring.make_client(",".join(ring))
    assert isinstance(rc, pring.RingFilerClient)
    assert rc.ring.members() == sorted(ring)


def test_ring_client_routes_and_trees_match(fleet):
    _, _, filers, ring = fleet
    rc = pring.RingFilerClient(ring)
    dirs = _covering(ring, [f"/bucket/dir{i}" for i in range(200)], 8)
    blobs = {f"{d}/file.txt": f"payload-{i}".encode() * 50 for i, d in enumerate(dirs)}
    for path, body in blobs.items():
        rc.put_object(path, body)
    spread = set()
    for path, body in blobs.items():
        assert rc.get_object(path)[:2] == (200, body), path
        owner = _owner_of(ring, path)
        spread.add(owner)
        status, _ = http_bytes("GET", f"http://{owner}{path}?meta=true&noRedirect=1")
        assert status == 200, f"{path} missing on its owner {owner}"
    assert spread == set(ring)


def test_dumb_client_follows_redirect_through_either_filer(fleet):
    _, _, filers, ring = fleet
    pring.RingFilerClient(ring).put_object("/bucket/redir/hop.txt", b"follow me")
    for f in filers:
        dumb = FilerClient(f.url)
        assert dumb.get_object("/bucket/redir/hop.txt")[:2] == (200, b"follow me"), f.url
        entry = dumb.get_entry("/bucket/redir/hop.txt")
        assert entry is not None and not entry.get("is_directory")


def test_raw_wire_foreign_path_is_307_with_location(fleet):
    _, _, filers, ring = fleet
    pring.RingFilerClient(ring).put_object("/bucket/wire/raw.txt", b"raw")
    owner = _owner_of(ring, "/bucket/wire/raw.txt")
    other = next(m for m in ring if m != owner)

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(NoRedirect)
    try:
        resp = opener.open(f"http://{other}/bucket/wire/raw.txt", timeout=10)
        status, headers = resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        status, headers = e.code, dict(e.headers)
    assert status == 307
    loc = headers.get("Location") or headers.get("location")
    assert loc == f"http://{owner}/bucket/wire/raw.txt?noRedirect=1"
    # HEAD and meta=true take the same gate; noRedirect=1 answers locally
    assert http_bytes("GET", f"http://{other}/bucket/wire/raw.txt?noRedirect=1")[0] == 404


def test_write_through_wrong_filer_proxies_to_owner(fleet):
    _, _, filers, ring = fleet
    owner = _owner_of(ring, "/bucket/proxied/by-wire.txt")
    other = next(m for m in ring if m != owner)
    assert http_bytes("POST", f"http://{other}/bucket/proxied/by-wire.txt",
                      b"proxied body")[0] == 201
    assert http_bytes(
        "GET", f"http://{owner}/bucket/proxied/by-wire.txt?meta=true&noRedirect=1")[0] == 200
    assert http_bytes(
        "GET", f"http://{other}/bucket/proxied/by-wire.txt?meta=true&noRedirect=1")[0] == 404
    assert FilerClient(other).get_object("/bucket/proxied/by-wire.txt")[:2] == \
        (200, b"proxied body")


def test_spine_listing_merges_across_members(fleet):
    _, _, filers, ring = fleet
    rc = pring.RingFilerClient(ring)
    names = set()
    for i in range(6):
        rc.put_object(f"/bucket/spine{i}/leaf.txt", b"x")
        names.add(f"spine{i}")
    for f in filers:
        listed = {e["name"] for e in FilerClient(f.url).list("/bucket")}
        assert names <= listed, (f.url, names - listed)
    assert names <= {e["name"] for e in rc.list("/bucket")}
    # the merged view pages as one sorted listing
    full = [e["name"] for e in rc.list("/bucket")]
    assert full == sorted(full)
    assert [e["name"] for e in FilerClient(ring[0]).list("/bucket", limit=3)] == full[:3]


def test_delete_through_wrong_filer(fleet):
    _, _, filers, ring = fleet
    rc = pring.RingFilerClient(ring)
    rc.put_object("/bucket/deleteme/gone.txt", b"bye")
    owner = _owner_of(ring, "/bucket/deleteme/gone.txt")
    other = next(m for m in ring if m != owner)
    assert FilerClient(other).delete("/bucket/deleteme/gone.txt") < 400
    assert rc.get_object("/bucket/deleteme/gone.txt")[0] == 404


def test_cross_shard_rename_through_ring_client(fleet):
    _, _, filers, ring = fleet
    rc = pring.RingFilerClient(ring)
    # two shard roots with different owners
    roots = [f"/bucket/mv{i}" for i in range(40)]
    src = roots[0]
    dst = next(r for r in roots if _owner_of(ring, r) != _owner_of(ring, src))
    rc.put_object(f"{src}/a/f.txt", b"moving bytes")
    other = next(m for m in ring if m != _owner_of(ring, src))
    st, _ = http_bytes("POST", f"http://{other}{src}?mv.to={dst}")
    assert st == 400  # a plain filer refuses a cross-shard rename
    rc.rename(src, dst)
    assert rc.get_object(f"{dst}/a/f.txt")[:2] == (200, b"moving bytes")
    assert rc.get_entry(src) is None


def test_fid_leases_served_writes(fleet):
    master, _, filers, _ = fleet
    minted = sum(http_json("GET", f"http://{f.url}/_status")["fid_leases"]["minted"]
                 for f in filers)
    assert minted > 0
    assert http_json("GET", f"http://{master.url}/dir/status")["fid_leases"]["granted"] > 0


def test_s3_gateway_fronts_the_fleet(fleet):
    from seaweedfs_tpu_torch.s3api import S3ApiServer
    from seaweedfs_tpu_torch.s3api.s3_client import S3Client

    _, _, filers, ring = fleet
    api = S3ApiServer(port=free_port(), filer_url=",".join(ring)).start()
    try:
        assert isinstance(api.client, pring.RingFilerClient)
        s3 = S3Client(f"http://{api.url}", "", "")
        # at the default depth a bucket (/buckets/<name>) is a shard root
        buckets = [x.rsplit("/", 1)[1] for x in _covering(
            ring, [f"/buckets/ringb{b}" for b in range(200)], 6)]
        objs = {(b, f"k{i}/o.bin"): bytes([j, i]) * (100 + i)
                for j, b in enumerate(buckets) for i in range(3)}
        for bucket in sorted({b for b, _ in objs}):
            assert s3.create_bucket(bucket)[0] == 200
        for (b, k), v in objs.items():
            assert s3.put_object(b, k, v)[0] == 200
        for (b, k), v in objs.items():
            assert s3.get_object(b, k)[:2] == (200, v)
            owner = _owner_of(ring, f"/buckets/{b}/{k}")
            assert http_bytes("GET", f"http://{owner}/buckets/{b}/{k}?noRedirect=1") == (200, v)
        assert {_owner_of(ring, f"/buckets/{b}") for b, _ in objs} == set(ring)
        status, body, _ = s3.list_objects(buckets[0], v2=True)
        assert status == 200 and all(k.encode() in body for b, k in objs if b == buckets[0])
        status, body, _ = s3.request("GET", "/")  # ListBuckets: the merged spine
        assert status == 200 and all(b.encode() in body for b in buckets)
    finally:
        api.stop()


# -- a mixed JAX/port ring against an all-JAX ring -----------------------------
def _write_fixed_tree(rc, tag: str) -> None:
    """Metadata entries with fixed chunk lists (so the hash is the same in
    every run) plus a spine dir, through a ring client."""
    now = 1_700_000_000
    rc.mkdir("/mixb")
    for i in range(24):
        path = f"/mixb/d{i % 7}/sub{i % 3}/f{i:02d}.bin"
        rc.create_entry(path, {
            "full_path": path, "is_directory": False, "mtime": now, "crtime": now,
            "mode": 0o644, "chunks": [{"file_id": f"3,{i + 1:x}0000{tag}", "offset": 0,
                                       "size": 10 + i, "mtime": now}]})


def _drop_pooled_connections() -> None:
    """Close this thread's keep-alive sockets: the next ring reuses the
    ports, and a pooled socket to the stopped filer would be stale."""
    from seaweedfs_tpu_torch.server import http_util

    for conn in list(getattr(http_util._pool_local, "conns", {}).values()):
        conn.close()
    http_util._pool_local.conns = {}


def _hashes(urls) -> dict:
    return {u: preshard.tree_hash(u, "/mixb") for u in urls}


def test_mixed_ring_serves_like_an_all_jax_ring(plane):
    master, _, tmp = plane
    ports = [free_port(), free_port()]
    ring = [f"127.0.0.1:{p}" for p in ports]

    def run(kinds, sub, last=False):
        filers = []
        for i, (kind, port) in enumerate(zip(kinds, ports)):
            cls = JFilerServer if kind == "jax" else PFilerServer
            kw = {"query_backend": "cpu"} if kind == "port" else {}
            filers.append(cls(port=port, master_url=master.url, chunk_size=64 * 1024,
                              db_path=str(tmp / f"mix_{sub}_{i}.db"), ring_peers=ring,
                              **kw).start())
        try:
            _write_fixed_tree(pring.RingFilerClient(ring), "beef")
            h = _hashes(ring)
            # the JAX package's tree_hash reads the same trees
            assert h == {u: jreshard.tree_hash(u, "/mixb") for u in ring}
            # a real object through a plain client on each member, read back
            # through the other
            for i, f in enumerate(filers):
                body = f"object {i} of {sub}".encode()
                FilerClient(f.url).put_object(f"/mixb/d{i}/o.txt", body)
                assert FilerClient(ring[1 - i]).get_object(f"/mixb/d{i}/o.txt")[:2] == \
                    (200, body)
            listing = [e["name"] for e in FilerClient(ring[1]).list("/mixb")]
            return h, listing
        finally:
            # the JAX filer's stop waits out its serving loop (~10 s): both
            # stop at once, and the ports are free when both are done; after
            # the last ring nothing waits for them
            stops = [threading.Thread(target=f.stop, daemon=True) for f in filers]
            for t in stops:
                t.start()
            if not last:
                for t in stops:
                    t.join()
            _drop_pooled_connections()

    jax_hash, jax_list = run(("jax", "jax"), "jj")
    mixed_hash, mixed_list = run(("jax", "port"), "jp", last=True)
    assert mixed_hash == jax_hash
    assert mixed_list == jax_list == [f"d{i}" for i in range(7)]
    assert len(set(jax_hash.values())) == 2  # each member holds its own share
