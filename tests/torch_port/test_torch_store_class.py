"""The port's ``Store`` class against the JAX package's ``Store``.

The same operations must give the same heartbeat and delta messages; the
same sealed volume must encode to the same 14 shards, .ecx and .vif; a
degraded read must take the remote shard fetch leg under the same retry
policy and fall back to reconstruction the same way; and each Store must
load and read a directory the other wrote. Heat values decay with the
clock, so they are compared apart from the rest of a message (present and
positive where an operation marked them). Every other comparison is byte or
value equality.
"""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.store import Store as JStore
from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.store import Store as PStore

HEAT = ("read_heat", "write_heat")
EXTS = [shard_ext(i) for i in range(14)] + [".ecx", ".vif"]


def _strip(obj):
    """A message with its clock-dependent heat values taken out."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in HEAT}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _stores(tmp_path, **kw):
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    ps = PStore([str(pdir)], ec_backend="cpu", **kw)
    js = JStore([str(jdir)], ec_backend="numpy", **kw)
    return ps, js


def _blobs(seed, n=40, lo=20_000, hi=400_000):
    rng = np.random.default_rng(seed)
    return {i: rng.bytes(int(rng.integers(lo, hi))) for i in range(1, n + 1)}


def _fill(store, mod, vid, blobs):
    for nid, data in blobs.items():
        store.write_volume_needle(vid, mod(cookie=0x77, id=nid, data=data))
    store.find_volume(vid).sync()


def _read(store, mod, vid, nid):
    n = mod(id=nid)
    store.read_volume_needle(vid, n)
    return n.cookie, n.data


def test_heartbeats_and_deltas_match(tmp_path):
    ps, js = _stores(tmp_path)
    steps = [
        lambda s, m: s.add_volume(1, collection="pics", replica_placement="001", ttl="3d"),
        lambda s, m: s.add_volume(2),
        lambda s, m: _fill(s, m, 1, _blobs(1, n=5, hi=30_000)),
        lambda s, m: s.delete_volume_needle(1, m(cookie=0x77, id=2)),
        lambda s, m: s.mark_volume_readonly(1),
        lambda s, m: s.unmount_volume(2),
        lambda s, m: s.mount_volume(2),
        lambda s, m: s.queue_new_ec_shards(9, "pics", 0b1011),
        lambda s, m: s.queue_deleted_ec_shards(9, "pics", 0b0001),
        lambda s, m: s.report_corrupt_needle(1, 4),
        lambda s, m: s.delete_volume(2),
    ]
    try:
        for i, step in enumerate(steps):
            got = [step(ps, PNeedle), step(js, JNeedle)]
            if not hasattr(got[0], "id"):  # a Volume is compared by its messages
                assert got[0] == got[1], i
            pd, jd = ps.drain_deltas(), js.drain_deltas()
            assert _strip(pd) == _strip(jd), i
            assert ps.delta_event.is_set() == js.delta_event.is_set()
            phb, jhb = ps.collect_heartbeat(), js.collect_heartbeat()
            assert _strip(phb) == _strip(jhb), i
            assert _strip(ps.collect_ec_heartbeat()) == _strip(js.collect_ec_heartbeat())
        vol = ps.collect_heartbeat()["volumes"][0]
        assert vol["write_heat"] > 0 and vol["corrupt_needles"] == 1
        assert ps.drain_deltas() == {} == js.drain_deltas()
    finally:
        ps.close()
        js.close()


def test_ec_encode_volume_matches_and_mounts(tmp_path):
    ps, js = _stores(tmp_path)
    blobs = _blobs(2)
    try:
        for s, m in ((ps, PNeedle), (js, JNeedle)):
            s.add_volume(3)
            _fill(s, m, 3, blobs)
        # the .dat files differ only in their append times; encode the same bytes
        shutil.copy(os.path.join(tmp_path / "jax", "3.dat"), tmp_path / "port" / "3.dat")
        shutil.copy(os.path.join(tmp_path / "jax", "3.idx"), tmp_path / "port" / "3.idx")
        assert ps.ec_encode_volume(3) == js.ec_encode_volume(3) == list(range(14))
        assert ps.find_volume(3).read_only
        for ext in EXTS:
            with open(tmp_path / "port" / f"3{ext}", "rb") as a, \
                    open(tmp_path / "jax" / f"3{ext}", "rb") as b:
                assert a.read() == b.read(), ext
        assert not [n for n in os.listdir(tmp_path / "port") if n.endswith(".tmp")]
        for s in (ps, js):
            s.delete_volume(3)
            s.locations[0].load_existing_volumes()
        assert _strip(ps.collect_ec_heartbeat()) == _strip(js.collect_ec_heartbeat())
        for nid in (1, 17, 40):
            assert _read(ps, PNeedle, 3, nid) == _read(js, JNeedle, 3, nid) == (0x77, blobs[nid])
    finally:
        ps.close()
        js.close()


@pytest.fixture
def degraded(tmp_path):
    """(port Store, JAX Store, blobs, lost shard bytes): the same EC volume
    mounted in both, with data shard 1 gone from disk."""
    ps, js = _stores(tmp_path, remote_fetch_backoff_s=0.001)
    blobs = _blobs(3, n=30, lo=100_000, hi=300_000)
    ps.add_volume(4)
    _fill(ps, PNeedle, 4, blobs)
    ps.ec_encode_volume(4)
    ps.delete_volume(4)
    base = tmp_path / "port" / "4"
    with open(f"{base}{shard_ext(1)}", "rb") as f:
        lost = f.read()
    os.remove(f"{base}{shard_ext(1)}")
    shutil.copytree(tmp_path / "port", tmp_path / "jax", dirs_exist_ok=True)
    for s in (ps, js):
        s.locations[0].load_existing_volumes()
        assert 1 not in s.find_ec_volume(4).shards
    yield ps, js, blobs, lost
    ps.close()
    js.close()


class _Stub:
    """A remote shard reader that answers with the lost shard's bytes,
    short bytes, or an error, and counts its calls."""

    def __init__(self, mode, lost):
        self.mode, self.lost, self.calls = mode, lost, 0

    def __call__(self, vid, sid, offset, size):
        self.calls += 1
        if self.mode == "ok":
            return self.lost[offset:offset + size]
        if self.mode == "short":
            return self.lost[offset:offset + size // 2]
        raise OSError("peer down")


@pytest.mark.parametrize("mode", ["ok", "short", "fails"])
def test_remote_fetch_leg_then_reconstruction(degraded, mode):
    ps, js, blobs, lost = degraded
    stubs = {}
    recon = {}
    for name, s in (("port", ps), ("jax", js)):
        stubs[name] = s.remote_shard_reader = _Stub(mode, lost)
        codec = s.ec_codec
        recon[name] = 0

        def counting(shards, data_only=False, _c=codec, _n=name, _f=codec.reconstruct):
            recon[_n] += 1
            return _f(shards, data_only=data_only)

        codec.reconstruct = counting
    for nid, want in blobs.items():
        assert _read(ps, PNeedle, 4, nid) == _read(js, JNeedle, 4, nid) == (0x77, want)
    assert stubs["port"].calls == stubs["jax"].calls > 0
    assert recon["port"] == recon["jax"]
    if mode == "ok":
        assert recon["port"] == 0
    else:
        # three attempts per lost interval, then one reconstruction each
        assert recon["port"] > 0 and stubs["port"].calls == 3 * recon["port"]


def test_no_remote_reader_reconstructs(degraded):
    ps, js, blobs, _ = degraded
    for nid, want in blobs.items():
        assert _read(ps, PNeedle, 4, nid) == (0x77, want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_store_loads_what_the_other_wrote(tmp_path, writer):
    """A directory with a plain volume and an EC volume (.ecx, .vif, a lost
    shard), written by one implementation, read in full by the other."""
    src = tmp_path / "src"
    wstore = (JStore if writer == "jax" else PStore)(
        [str(src)], ec_backend="numpy" if writer == "jax" else "cpu")
    mod = JNeedle if writer == "jax" else PNeedle
    plain, ec = _blobs(5, n=12, hi=50_000), _blobs(6, n=25, lo=100_000, hi=300_000)
    try:
        wstore.add_volume(5, collection="c")
        _fill(wstore, mod, 5, plain)
        wstore.add_volume(6)
        _fill(wstore, mod, 6, ec)
        wstore.ec_encode_volume(6)
        wstore.delete_volume(6)
    finally:
        wstore.close()
    os.remove(src / f"6{shard_ext(3)}")
    rstore = (PStore if writer == "jax" else JStore)(
        [str(src)], ec_backend="cpu" if writer == "jax" else "numpy")
    rmod = PNeedle if writer == "jax" else JNeedle
    try:
        assert rstore.find_volume(5).collection == "c"
        assert sorted(rstore.find_ec_volume(6).shard_ids()) == [s for s in range(14) if s != 3]
        for nid, want in plain.items():
            assert _read(rstore, rmod, 5, nid) == (0x77, want)
        for nid, want in ec.items():
            assert _read(rstore, rmod, 6, nid) == (0x77, want)
    finally:
        rstore.close()
