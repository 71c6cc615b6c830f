"""The port's subtree reshard (``filer/reshard.py``, ``POST /_reshard``) held
against the JAX package's.

On a fleet of two port filers (``ring_peers``) over a port master and volume
server: the reference's round trip (``tests/test_meta_shard.py``), re-driven
to prove it a no-op, and ``/_reshard`` driving the move. The reference's
killed-reshard matrix (``tests/test_reshard_chaos.py``) on two port filers
over persistent sqlite stores: an io-error at each protocol window
(``reshard.apply``, ``reshard.checkpoint``, ``reshard.done``,
``reshard.purge``), the target filer bounced where the reference bounces
it, and the re-driven move converging with no duplicate or lost entry and
no marker left. The port's ``tree_hash`` equals the JAX package's on the
same filers, and a move the port's ``Resharder`` left half done is finished
by the JAX package's (the marker and checkpoint keys are shared).
"""

import hashlib
import socket
import time

import pytest

from seaweedfs_tpu.filer import reshard as jreshard
from seaweedfs_tpu.server.filer_server import FilerServer as JFilerServer
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.filer.reshard import Resharder, tree_hash
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util import faultpoints


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshardfleet")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    volume = VolumeServer([str(tmp / "vol")], port=free_port(), master_url=master.url,
                          max_volume_count=20, pulse_seconds=0.5, ec_backend="cpu").start()
    p1, p2 = free_port(), free_port()
    ring = [f"127.0.0.1:{p1}", f"127.0.0.1:{p2}"]
    filers = [FilerServer(port=p, master_url=master.url, chunk_size=64 * 1024,
                          db_path=str(tmp / f"filer{i}.db"), ring_peers=ring,
                          query_backend="cpu").start()
              for i, p in enumerate((p1, p2))]
    deadline = time.time() + 10
    while time.time() < deadline and not master.master.topo.data_nodes():
        time.sleep(0.05)
    yield master, volume, filers, ring
    for f in filers:
        f.stop()
    volume.stop()
    master.stop()


def test_reshard_round_trip(fleet):
    """Subtree move between fleet members: identical tree on the target,
    source purged, markers gone; driven twice to prove re-drivability."""
    _, _, _, ring = fleet
    src_url, dst_url = ring
    for i in range(7):
        assert http_bytes("POST", f"http://{src_url}/moving/sub{i % 2}/f{i}.txt?noRedirect=1",
                          f"blob-{i}".encode())[0] == 201
    before = tree_hash(src_url, "/moving")
    r1 = Resharder(src_url, dst_url, "/moving", epoch="77", ckpt_every=3).run()
    assert r1["applied"] == 10 and r1["marker_skips"] == r1["ckpt_skips"] == 0
    assert tree_hash(dst_url, "/moving") == before
    assert http_bytes("GET", f"http://{src_url}/moving?meta=true&noRedirect=1")[0] == 404
    # the chunks are shared: the bytes read back from the target
    for i in range(7):
        assert http_bytes("GET", f"http://{dst_url}/moving/sub{i % 2}/f{i}.txt?noRedirect=1") \
            == (200, f"blob-{i}".encode())
    r2 = Resharder(src_url, dst_url, "/moving", epoch="77", ckpt_every=3).run()
    assert r2["applied"] == 0
    assert tree_hash(dst_url, "/moving") == before
    sha = hashlib.sha1(b"/moving").hexdigest()
    c = FilerClient(dst_url)
    assert c.kv_get(f"reshard.done.77.{sha}") is None
    assert c.kv_get(f"reshard.ckpt.77.{sha}") is None


def test_reshard_endpoint_drives_the_move(fleet):
    _, _, _, ring = fleet
    src_url, dst_url = ring
    http_bytes("POST", f"http://{src_url}/ep-move/one.txt?noRedirect=1", b"endpoint move")
    before = tree_hash(src_url, "/ep-move")
    out = http_json("POST", f"http://{src_url}/_reshard?root=/ep-move&target={dst_url}&epoch=9")
    assert out == {"root": "/ep-move", "epoch": "9", "applied": 2, "marker_skips": 0,
                   "ckpt_skips": 0, "resumed_from": ""}
    assert tree_hash(dst_url, "/ep-move") == before
    st, body = http_bytes("POST", f"http://{src_url}/_reshard?root=/ep-move")
    assert st == 400 and b"required" in body


def test_tree_hash_equals_jax(fleet):
    _, _, filers, ring = fleet
    c = FilerClient(ring[0])
    for i in range(9):
        c.create_entry(f"/hashme/d{i % 3}/f{i}", {
            "full_path": f"/hashme/d{i % 3}/f{i}", "is_directory": False, "mtime": 1,
            "chunks": [{"file_id": f"7,{i:x}01", "offset": 0, "size": i + 1}]})
    for root in ("/hashme", "/hashme/d1", "/nothing-here", "/"):
        for url in ring:
            assert tree_hash(url, root) == jreshard.tree_hash(url, root), (url, root)
    assert tree_hash(ring[0], "/hashme") != tree_hash(ring[1], "/hashme")


# -- the killed-reshard matrix (tests/test_reshard_chaos.py) -------------------
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Source and target port filers over persistent sqlite stores (so a
    bounced filer resumes from durable state), one master."""
    tmp = tmp_path_factory.mktemp("reshardchaos")
    master = MasterServer(port=free_port(), node_timeout=60).start()
    state = {"tmp": tmp, "master": master, "filers": {}}

    def boot(name):
        port = state["filers"][name].port if name in state["filers"] else free_port()
        srv = FilerServer(port=port, master_url=master.url, db_path=str(tmp / f"{name}.db"),
                          query_backend="cpu").start()
        state["filers"][name] = srv
        return srv

    boot("src")
    boot("dst")
    state["boot"] = boot
    yield state
    for f in state["filers"].values():
        f.stop()
    master.stop()


def _seed_tree(filer_url: str, root: str, files: int = 24) -> str:
    """Metadata-only subtree: nested dirs with empty-chunk file entries."""
    c = FilerClient(filer_url)
    now = int(time.time())
    for i in range(files):
        path = f"{root}/d{i % 4}/f{i:03d}.txt"
        c.create_entry(path, {"full_path": path, "is_directory": False, "mtime": now,
                              "chunks": []})
    return tree_hash(filer_url, root)


def _count_tree(filer_url: str, root: str) -> int:
    c = FilerClient(filer_url)
    n, stack = 0, [root]
    while stack:
        d = stack.pop()
        for e in c.list(d):
            n += 1
            if e.get("is_directory"):
                stack.append(f"{d.rstrip('/')}/{e['name']}")
    return n


WINDOWS = [
    # (faultpoint, skip_hits, bounce_target)
    ("reshard.apply", 3, False),
    ("reshard.apply", 12, True),       # mid-copy + target filer killed
    ("reshard.checkpoint", 1, True),   # right after a durable checkpoint
    ("reshard.done", 0, False),        # copy done, purge never ran
    ("reshard.purge", 0, True),        # purged, marker GC never ran
]


@pytest.mark.crash
@pytest.mark.parametrize("point,skip,bounce", WINDOWS,
                         ids=[f"{p}@{s}{'+bounce' if b else ''}" for p, s, b in WINDOWS])
def test_killed_reshard_converges(pair, point, skip, bounce):
    src, dst = pair["filers"]["src"], pair["filers"]["dst"]
    root = f"/chaos-{point.split('.')[1]}-{skip}"
    before = _seed_tree(src.url, root)
    n_before = _count_tree(src.url, root)
    epoch = f"e-{point}-{skip}"

    faultpoints.arm(point, "io-error", skip=skip, count=1)
    try:
        with pytest.raises(OSError):
            Resharder(src.url, dst.url, root, epoch, ckpt_every=4).run()
    finally:
        faultpoints.disarm(point)
    assert faultpoints.hits(point) >= 1

    if bounce:
        # kill the target filer: new process-state over the same store
        pair["filers"]["dst"].stop()
        dst = pair["boot"]("dst")

    summary = Resharder(src.url, dst.url, root, epoch, ckpt_every=4).run()
    assert tree_hash(dst.url, root) == before, summary
    assert _count_tree(dst.url, root) == n_before, "dupes or drops"
    assert FilerClient(src.url).get_entry(root) is None
    c = FilerClient(dst.url)
    sha = hashlib.sha1(root.encode()).hexdigest()
    assert c.kv_get(f"reshard.done.{epoch}.{sha}") is None
    assert c.kv_get(f"reshard.ckpt.{epoch}.{sha}") is None


@pytest.mark.crash
def test_double_kill_same_epoch_converges(pair):
    src, dst = pair["filers"]["src"], pair["filers"]["dst"]
    root = "/chaos-double"
    before = _seed_tree(src.url, root, files=30)
    n_before = _count_tree(src.url, root)
    for point, skip in (("reshard.apply", 5), ("reshard.apply", 18)):
        faultpoints.arm(point, "io-error", skip=skip, count=1)
        try:
            with pytest.raises(OSError):
                Resharder(src.url, dst.url, root, "dbl", ckpt_every=4).run()
        finally:
            faultpoints.disarm(point)
    summary = Resharder(src.url, dst.url, root, "dbl", ckpt_every=4).run()
    assert tree_hash(dst.url, root) == before, summary
    assert _count_tree(dst.url, root) == n_before
    assert summary["ckpt_skips"] + summary["marker_skips"] > 0


@pytest.mark.crash
def test_clean_reshard_baseline(pair):
    src, dst = pair["filers"]["src"], pair["filers"]["dst"]
    root = "/chaos-clean"
    before = _seed_tree(src.url, root, files=10)
    summary = Resharder(src.url, dst.url, root, "clean").run()
    assert summary["applied"] >= 10 and summary["resumed_from"] == ""
    assert tree_hash(dst.url, root) == before


@pytest.mark.crash
def test_port_move_finished_by_the_jax_resharder(pair):
    """The port's Resharder killed after a checkpoint; the JAX package's,
    on the same epoch, resumes from that checkpoint and its markers."""
    src, dst = pair["filers"]["src"], pair["filers"]["dst"]
    root = "/chaos-cross"
    before = _seed_tree(src.url, root, files=20)
    n_before = _count_tree(src.url, root)
    faultpoints.arm("reshard.apply", "io-error", skip=9, count=1)
    try:
        with pytest.raises(OSError):
            Resharder(src.url, dst.url, root, "x", ckpt_every=4).run()
    finally:
        faultpoints.disarm("reshard.apply")
    summary = jreshard.Resharder(src.url, dst.url, root, "x", ckpt_every=4).run()
    assert summary["resumed_from"] != "" and summary["ckpt_skips"] > 0, summary
    assert tree_hash(dst.url, root) == before
    assert _count_tree(dst.url, root) == n_before
    assert FilerClient(src.url).get_entry(root) is None


def test_port_resharder_moves_between_jax_filers(pair, tmp_path):
    """The port's Resharder drives a move between two JAX filers (the
    ``noRedirect`` hops, the KV markers and the metadata-only purge are
    the same protocol on either package's filer)."""
    master = pair["master"]
    a = JFilerServer(port=free_port(), master_url=master.url, db_path=str(tmp_path / "a.db"))
    b = JFilerServer(port=free_port(), master_url=master.url, db_path=str(tmp_path / "b.db"))
    a.start()
    b.start()
    try:
        want = _seed_tree(a.url, "/chaos-jj", files=12)
        summary = Resharder(a.url, b.url, "/chaos-jj", "jj", ckpt_every=4).run()
        assert summary["applied"] == 12 + 4 + 1
        assert tree_hash(b.url, "/chaos-jj") == want
        assert FilerClient(a.url).get_entry("/chaos-jj") is None
    finally:
        import threading

        for f in (a, b):  # the JAX filer's stop waits out its serving loop
            threading.Thread(target=f.stop, daemon=True).start()
