"""The port's ``Volume`` against the JAX package's, byte for byte.

The same seeded needles (with fixed append times) go through both; the
.dat and .idx files must be identical, and so must every read, every
delete's result, the counters, the torn-tail repair on reload and the
lookups of the ``dense`` and ``memory`` needle maps.
"""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import needle as jneedle
from seaweedfs_tpu.storage.ttl import read_ttl as jread_ttl
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu_torch.storage import needle as pneedle
from seaweedfs_tpu_torch.storage.ttl import read_ttl as pread_ttl
from seaweedfs_tpu_torch.storage.volume import Volume as PVolume

VID = 7
T0 = 1_700_000_000_000_000_000  # append times are fixed, so files compare


def _ops(seed: int):
    """A seeded history: writes (some with name/mime/last-modified, some
    overwrites and unchanged re-writes) and deletes."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(1, 81):
        size = int(np.exp(rng.uniform(np.log(1), np.log(40_000))))
        ops.append(("put", i, 0x1000 + i, rng.bytes(size), i % 3 == 0))
    for i in rng.choice(np.arange(1, 81), 10, replace=False):
        ops.append(("put", int(i), 0x1000 + int(i), rng.bytes(500), False))  # overwrite
    ops.append(("put", 5, 0x1005, None, False))  # unchanged re-write of the latest bytes
    for i in rng.choice(np.arange(1, 81), 12, replace=False):
        ops.append(("delete", int(i)))
    ops.append(("delete", 999))  # absent
    return ops


def _needle(mod, nid, cookie, data, meta):
    n = mod.Needle(cookie=cookie, id=nid, data=data)
    if meta:
        n.name, n.mime = f"file{nid}.bin".encode(), b"application/x-test"
        n.last_modified = 1_690_000_000 + nid
        for flag in (mod.FLAG_HAS_NAME, mod.FLAG_HAS_MIME, mod.FLAG_HAS_LAST_MODIFIED):
            n.set_flag(flag)
    return n


def _replay(v, mod, ops):
    results, latest = [], {}
    for t, op in enumerate(ops):
        if op[0] == "put":
            _, nid, cookie, data, meta = op
            data = latest[nid] if data is None else data
            latest[nid] = data
            results.append(v.write_needle(_needle(mod, nid, cookie, data, meta),
                                          append_at_ns=T0 + t))
        else:
            results.append(v.delete_needle(mod.Needle(cookie=0x1000 + op[1], id=op[1]),
                                           append_at_ns=T0 + t))
    v.sync()
    return results


def _read(v, mod, nid):
    n = mod.Needle(id=nid)
    try:
        size = v.read_needle(n)
    except Exception as e:  # noqa: BLE001 — the error's kind is compared
        return type(e).__name__
    return size, n.cookie, n.data, n.name, n.mime, n.flags, n.last_modified, n.append_at_ns


def _files(d):
    out = {}
    for ext in (".dat", ".idx"):
        with open(os.path.join(d, f"{VID}{ext}"), "rb") as f:
            out[ext] = f.read()
    return out


def _counters(v):
    return (v.file_count(), v.deleted_count(), v.content_size(), v.deleted_size(),
            v.max_file_key(), v.size(), v.last_append_at_ns)


@pytest.fixture
def written(tmp_path):
    """(port dir, JAX dir, ops, port results, JAX results): one history
    written through each implementation, volumes closed."""
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    ops = _ops(31)
    os.makedirs(pdir)
    os.makedirs(jdir)
    pv, jv = PVolume(pdir, "", VID), JVolume(jdir, "", VID)
    try:
        pres, jres = _replay(pv, pneedle, ops), _replay(jv, jneedle, ops)
    finally:
        pv.close()
        jv.close()
    return pdir, jdir, ops, pres, jres


def test_writes_and_deletes_make_identical_files(written):
    pdir, jdir, _, pres, jres = written
    assert pres == jres
    assert pres[0][2] is False  # a real append
    assert any(r[2] for r in pres if isinstance(r, tuple))  # the unchanged re-write
    assert _files(pdir) == _files(jdir)


@pytest.mark.parametrize("kind", ["dense", "memory"])
def test_reads_and_counters_agree_after_reload(written, kind):
    pdir, jdir, ops, _, _ = written
    pv = PVolume(pdir, "", VID, create_if_missing=False, needle_map_kind=kind)
    jv = JVolume(jdir, "", VID, create_if_missing=False, needle_map_kind=kind)
    try:
        assert _counters(pv) == _counters(jv)
        for nid in range(0, 82):
            assert _read(pv, pneedle, nid) == _read(jv, jneedle, nid), nid
        assert pv.read_needle(pneedle.Needle(id=3)) > 0
        assert _read(pv, pneedle, 999) == "NotFoundError"
    finally:
        pv.close()
        jv.close()


def test_dense_and_memory_maps_agree(written):
    pdir, _, _, _, _ = written
    dense = PVolume(pdir, "", VID, create_if_missing=False, needle_map_kind="dense")
    try:
        mem_dir = pdir + "_mem"
        shutil.copytree(pdir, mem_dir)
        mem = PVolume(mem_dir, "", VID, create_if_missing=False, needle_map_kind="memory")
        try:
            seen_dense, seen_mem = [], []
            dense.nm.ascending_visit(lambda nv: seen_dense.append(nv))
            mem.nm.ascending_visit(lambda nv: seen_mem.append(nv))
            assert seen_dense == seen_mem and len(seen_dense) == 80
            for nid in range(0, 1000):
                assert dense.nm.get(nid) == mem.nm.get(nid)
            assert _counters(dense) == _counters(mem)
        finally:
            mem.close()
    finally:
        dense.close()


@pytest.mark.parametrize("tear", ["half_record", "idx_past_dat", "ragged_idx"])
def test_torn_tail_is_repaired_as_the_reference_repairs_it(written, tear):
    pdir, jdir, _, _, _ = written
    for d in (pdir, jdir):
        dat, idx = (os.path.join(d, f"{VID}{e}") for e in (".dat", ".idx"))
        if tear == "half_record":
            # the last record and its .idx entry, cut halfway through the record
            size = os.path.getsize(dat)
            with open(dat, "r+b") as f:
                f.truncate(size - 20)
        elif tear == "idx_past_dat":
            # an .idx entry for a record that never reached the .dat
            with open(idx, "ab") as f:
                f.write((12345).to_bytes(8, "big") + (os.path.getsize(dat) // 8).to_bytes(4, "big")
                        + (100).to_bytes(4, "big"))
        else:
            with open(idx, "ab") as f:
                f.write(b"\x00" * 7)  # a partial entry
    pv = PVolume(pdir, "", VID, create_if_missing=False)
    jv = JVolume(jdir, "", VID, create_if_missing=False)
    try:
        assert _counters(pv) == _counters(jv)
        # the repaired volume takes new writes at the same offsets
        res = [v.write_needle(mod.Needle(cookie=1, id=500, data=b"after repair"),
                              append_at_ns=T0 + 10_000)
               for v, mod in ((pv, pneedle), (jv, jneedle))]
        assert res[0] == res[1]
        for nid in list(range(1, 81)) + [500]:
            assert _read(pv, pneedle, nid) == _read(jv, jneedle, nid), nid
    finally:
        pv.close()
        jv.close()
    assert _files(pdir) == _files(jdir)


def test_ttl_volume_and_destroy(tmp_path):
    """A volume-level TTL is stamped on needles as the reference stamps it;
    destroy removes every file."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    pv = PVolume(str(tmp_path / "p"), "col", VID, ttl=pread_ttl("3d"))
    jv = JVolume(str(tmp_path / "j"), "col", VID, ttl=jread_ttl("3d"))
    for v, mod in ((pv, pneedle), (jv, jneedle)):
        v.write_needle(mod.Needle(cookie=9, id=1, data=b"x" * 100), append_at_ns=T0)
        v.sync()
    with open(pv.file_name() + ".dat", "rb") as a, open(jv.file_name() + ".dat", "rb") as b:
        assert a.read() == b.read()
    assert [n.id for n, _, _ in pv.scan_needles()] == [n.id for n, _, _ in jv.scan_needles()]
    pv.destroy()
    jv.close()
    assert not os.listdir(tmp_path / "p")


@pytest.mark.parametrize("kind", ["sqlite", "sorted", "mmap"])
def test_unported_needle_maps_say_so(tmp_path, kind):
    """A kind that neither package serves (these kinds are ported now, so
    the kind with a suffix) is refused by name and leaves nothing behind."""
    with pytest.raises(ValueError, match="unknown needle map kind"):
        PVolume(str(tmp_path), "", VID, needle_map_kind=kind + "x")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("kind", ["sqlite", "sorted", "mmap"])
def test_every_needle_map_kind_loads(tmp_path, kind):
    """Each kind loads: the volume serves from its own index file
    (test_torch_needle_map_kinds.py holds the files against the JAX
    package's), and destroy removes it."""
    v = PVolume(str(tmp_path), "", VID, needle_map_kind=kind)
    assert v.read_only == (kind == "sorted")
    ext = {"sqlite": ".ldb", "sorted": ".sdx", "mmap": ".mdx"}[kind]
    assert os.path.exists(v.file_name() + ext)
    v.destroy()
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("kind", ["memory", "dense", "sqlite", "mmap"])
def test_a_failed_idx_fsync_fails_the_write(tmp_path, monkeypatch, kind):
    """A write that asks for fsync is not acknowledged when the .idx fsync
    fails (EIO): the error reaches the caller, whatever the map kind."""
    import errno

    v = PVolume(str(tmp_path), "", VID, needle_map_kind=kind)
    try:
        idx_fd = v.nm._index_file.fileno()
        real = os.fsync

        def fsync(fd):
            if fd == idx_fd:
                raise OSError(errno.EIO, "injected EIO on the .idx")
            real(fd)

        monkeypatch.setattr(os, "fsync", fsync)
        with pytest.raises(OSError, match="injected EIO"):
            v.write_needle(pneedle.Needle(cookie=9, id=1, data=b"x" * 100), fsync=True)
        v.write_needle(pneedle.Needle(cookie=9, id=2, data=b"y" * 100))  # no fsync asked
        monkeypatch.setattr(os, "fsync", real)
    finally:
        v.close()


def test_key_ordered_index_keeps_every_record(tmp_path):
    """A decoded volume's .idx lists its entries in key order (it is made
    from the .ecx), so its last entry need not be the last record of the
    .dat. Reloading must keep every record: only bytes past the end of the
    furthest record the index knows are a torn tail."""
    d = str(tmp_path)
    v = PVolume(d, "", VID)
    keys = [3, 9, 1, 7, 2]  # appended out of key order
    for t, nid in enumerate(keys):
        v.write_needle(pneedle.Needle(cookie=5, id=nid, data=bytes([nid]) * (100 * nid)),
                       append_at_ns=T0 + t)
    v.close()
    dat, idx = (os.path.join(d, f"{VID}{e}") for e in (".dat", ".idx"))
    with open(idx, "rb") as f:
        raw = f.read()
    entries = sorted(raw[i:i + 16] for i in range(0, len(raw), 16))
    with open(idx, "wb") as f:
        f.write(b"".join(entries))
    size = os.path.getsize(dat)
    with open(dat, "ab") as f:
        f.write(b"\x07" * 13)  # and a torn tail past the last record
    v = PVolume(d, "", VID, create_if_missing=False)
    try:
        assert os.path.getsize(dat) == size
        for nid in keys:
            assert _read(v, pneedle, nid)[2] == bytes([nid]) * (100 * nid)
    finally:
        v.close()
