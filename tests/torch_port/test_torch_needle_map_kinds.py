"""The port's ``sqlite``, ``sorted`` and ``mmap`` needle maps against the JAX
package's, on the cases of ``tests/test_needle_map_dense.py``.

Each kind is driven with the same .idx history or the same put/delete
sequence in both packages: lookups, the mapMetric counters, ascending
visits and the files written (``.idx`` log, ``.ldb`` meta, ``.sdx``,
``.mdx`` and its sidecar) must agree, and each package must load the
other's files without replaying the .idx.
"""

import io
import os
import random

import pytest

from seaweedfs_tpu.storage import idx as jidx
from seaweedfs_tpu.storage import needle_map_dense as jdense
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu.storage.needle_map import CompactNeedleMap as JCompact
from seaweedfs_tpu.storage.volume import Volume as JVolume
from seaweedfs_tpu_torch.storage import needle_map_dense as pdense
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle
from seaweedfs_tpu_torch.storage.types import TOMBSTONE_FILE_SIZE
from seaweedfs_tpu_torch.storage.volume import DeletedError, NotFoundError, VolumeError
from seaweedfs_tpu_torch.storage.volume import Volume as PVolume

KINDS = ["sqlite", "mmap"]
FILE_EXT = {"sqlite": ".ldb", "mmap": ".mdx"}
CLASS = {"sqlite": "SqliteNeedleMap", "mmap": "MmapNeedleMap"}


def random_history(n_ops=3000, key_space=800, seed=7, offset_size=4):
    """A put/delete/overwrite history as raw .idx bytes (the reference
    test's generator)."""
    rng = random.Random(seed)
    out = io.BytesIO()
    offset = 8
    for _ in range(n_ops):
        key = rng.randrange(1, key_space)
        if rng.random() < 0.25:
            out.write(jidx.pack_entry(key, offset, TOMBSTONE_FILE_SIZE, offset_size))
        else:
            size = rng.randrange(1, 5000)
            out.write(jidx.pack_entry(key, offset, size, offset_size))
            offset += ((size + 7) // 8 + 5) * 8
    return out.getvalue()


def load(mod, kind, raw, path, offset_size=4, index_file=None):
    f = index_file if index_file is not None else io.BytesIO(raw)
    return getattr(mod, CLASS[kind]).load(f, str(path), offset_size)


def state(nm, keys=range(1, 900)):
    vals = [(nv.key, nv.offset, nv.size) for k in keys if (nv := nm.get(k)) is not None]
    seen = []
    nm.ascending_visit(lambda v: seen.append((v.key, v.offset, v.size)))
    return (nm.file_count(), nm.content_size(), nm.deleted_count(), nm.deleted_size(),
            nm.max_file_key, vals, seen)


def _no_replay(monkeypatch, mod, kind):
    def refuse(self):
        raise AssertionError("the .idx was replayed: the other package's file was not used")
    monkeypatch.setattr(getattr(mod, CLASS[kind]), "_rebuild_from_idx", refuse)


@pytest.mark.parametrize("offset_size", [4, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_load_matches_jax_kind(kind, offset_size, tmp_path):
    raw = random_history(offset_size=offset_size)
    jnm = load(jdense, kind, raw, tmp_path / ("j" + FILE_EXT[kind]), offset_size)
    pnm = load(pdense, kind, raw, tmp_path / ("p" + FILE_EXT[kind]), offset_size)
    dict_kind = JCompact.load(io.BytesIO(raw), offset_size)
    assert state(pnm) == state(jnm) == state(dict_kind)
    assert len(pnm) == len(jnm)
    if kind == "mmap":
        assert (tmp_path / "p.mdx").read_bytes() == (tmp_path / "j.mdx").read_bytes()
    pnm.release()
    jnm.release()


@pytest.mark.parametrize("kind", KINDS)
def test_mutations_match_jax_kind(kind, tmp_path):
    """The same put/get/delete sequence, with overflow merges forced in the
    mmap kind: the same lookups, counters and .idx bytes."""
    jf, pf = io.BytesIO(), io.BytesIO()
    jnm = load(jdense, kind, b"", tmp_path / ("j" + FILE_EXT[kind]), index_file=jf)
    pnm = load(pdense, kind, b"", tmp_path / ("p" + FILE_EXT[kind]), index_file=pf)
    if kind == "mmap":
        jnm.MERGE_THRESHOLD = pnm.MERGE_THRESHOLD = 50
    rng = random.Random(3)
    offset = 8
    for _ in range(2000):
        key = rng.randrange(1, 400)
        if rng.random() < 0.3:
            jnm.delete(key, offset)
            pnm.delete(key, offset)
        else:
            size = rng.randrange(1, 1000)
            jnm.put(key, offset, size)
            pnm.put(key, offset, size)
            offset += ((size + 7) // 8 + 5) * 8
    assert state(pnm, range(1, 400)) == state(jnm, range(1, 400))
    assert pf.getvalue() == jf.getvalue()
    if kind == "mmap":
        assert pnm.merge_count == jnm.merge_count > 0
    pnm.release()
    jnm.release()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_files_interchange(kind, writer, tmp_path, monkeypatch):
    """One package loads, mutates and syncs; the other loads the same .idx
    and the first one's .ldb / .mdx (+ .meta) without replaying the .idx,
    and sees the same map."""
    src, dst = (jdense, pdense) if writer == "jax" else (pdense, jdense)
    path = tmp_path / ("v" + FILE_EXT[kind])
    raw = random_history(800, 200, seed=11)
    idx = io.BytesIO(raw)
    nm = load(src, kind, raw, path, index_file=idx)
    for k in range(190, 260):
        nm.put(k, 1 << 20 | k * 8, 100 + k)
    for k in range(1, 20):
        nm.delete(k, 1 << 21)
    if kind == "mmap":
        nm._merge_overflow()  # the base and sidecar now hold every mutation
    nm.sync()
    want = state(nm, range(1, 300))
    nm.release()
    _no_replay(monkeypatch, dst, kind)
    got = load(dst, kind, idx.getvalue(), path)
    assert state(got, range(1, 300)) == want
    got.release()


@pytest.mark.parametrize("offset_size", [4, 5])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sorted_index_interchanges(writer, offset_size, tmp_path):
    """write_sorted_index makes the same .sdx in both packages, and either
    package's SortedFileNeedleMap serves the other's file."""
    raw = random_history(1500, 500, seed=5, offset_size=offset_size)
    jdense.write_sorted_index(raw, str(tmp_path / "j.sdx"), offset_size)
    pdense.write_sorted_index(raw, str(tmp_path / "p.sdx"), offset_size)
    assert (tmp_path / "p.sdx").read_bytes() == (tmp_path / "j.sdx").read_bytes()
    made = tmp_path / ("j.sdx" if writer == "jax" else "p.sdx")
    pnm = pdense.SortedFileNeedleMap(str(made), offset_size)
    jnm = jdense.SortedFileNeedleMap(str(made), offset_size)
    assert state(pnm, range(1, 520)) == state(jnm, range(1, 520))
    assert len(pnm) == len(jnm)
    with pytest.raises(io.UnsupportedOperation):
        pnm.put(5, 8, 8)
    with pytest.raises(io.UnsupportedOperation):
        pnm.delete(5, 8)
    pnm.close()
    jnm.close()


def test_sorted_file_kind(tmp_path):
    entries = sorted((k, k * 1024, 100 + k) for k in range(1, 200, 3))
    p = tmp_path / "vol.sdx"
    with open(p, "wb") as f:
        for k, off, size in entries:
            f.write(jidx.pack_entry(k, off, size))
    nm = pdense.SortedFileNeedleMap(str(p))
    assert len(nm) == len(entries)
    for k, off, size in entries:
        v = nm.get(k)
        assert v and v.offset == off and v.size == size
    assert nm.get(2) is None
    nm.close()


@pytest.mark.parametrize("kind", KINDS)
def test_reopen_and_crash_replay(kind, tmp_path):
    """A clean reopen uses the committed meta (sqlite) or sidecar (mmap); an
    .idx that grew past it, or a torn sidecar, forces a full replay."""
    raw = random_history(500, 100)
    path = tmp_path / ("v" + FILE_EXT[kind])
    nm = load(pdense, kind, raw, path)
    nm.sync()
    snap = state(nm, range(1, 110))
    nm.release()
    nm2 = load(pdense, kind, raw, path)
    assert state(nm2, range(1, 110)) == snap
    nm2.release()
    raw2 = raw + jidx.pack_entry(7, 1 << 20, 999)
    nm3 = load(pdense, kind, raw2, path)
    assert nm3.get(7).size == 999
    nm3.release()
    if kind == "mmap":
        (tmp_path / "v.mdx.meta").write_text('{"idx_size": 1')
        nm4 = load(pdense, kind, raw2, path)
        assert nm4.get(7).size == 999 and nm4.file_count() == nm3.file_count()
        nm4.release()


def test_sqlite_high_bit_keys(tmp_path):
    """Needle ids are full u64: keys >= 2^63 keep their order (bias-shifted)."""
    nm = pdense.SqliteNeedleMap.load(io.BytesIO(), str(tmp_path / "hb.ldb"), 4)
    hi = 0xFFFFFFFFFFFFFFF0
    nm.put(hi, 64, 100)
    nm.put(5, 128, 50)
    assert nm.get(hi).offset == 64 and nm.max_file_key == hi
    assert [v.key for v in nm.items()] == [5, hi]
    nm.delete(hi, 256)
    assert nm.get(hi).size == -100
    nm.sync()
    nm.release()
    # both kinds reopen the same db through its meta alike: the meta's
    # INTEGER column turns a u64 past 2^63 into a REAL, so max_file_key
    # comes back rounded, in both packages (a fault of the format, kept)
    raw = jidx.pack_entry(hi, 64, 100) + jidx.pack_entry(5, 128, 50) + jidx.pack_entry(
        hi, 256, TOMBSTONE_FILE_SIZE)
    jnm = jdense.SqliteNeedleMap.load(io.BytesIO(raw), str(tmp_path / "hb.ldb"), 4)
    pnm = pdense.SqliteNeedleMap.load(io.BytesIO(raw), str(tmp_path / "hb.ldb"), 4)
    assert pnm.max_file_key == jnm.max_file_key == float(hi)
    assert state(pnm, [5, hi]) == state(jnm, [5, hi])
    assert pnm.get(hi).size == -100
    jnm.release()
    pnm.release()


@pytest.mark.parametrize("cls", ["SqliteNeedleMap", "MmapNeedleMap"])
def test_close_keeps_meta_and_destroy_removes_files(cls, tmp_path):
    """close() commits the meta against the .idx's size before the .idx
    closes, so the next load takes the fast path; destroy() leaves no file
    of the map behind (no sqlite WAL either)."""
    raw = random_history(100, 40)
    ext = ".ldb" if cls == "SqliteNeedleMap" else ".mdx"
    base = str(tmp_path / ("d" + ext))
    nm = getattr(pdense, cls).load(io.BytesIO(raw), base, 4)
    nm.put(7, 8 << 20, 99)
    nm.close()
    f = io.BytesIO(raw + jidx.pack_entry(7, 8 << 20, 99))
    nm2 = getattr(pdense, cls).load(f, base, 4)
    assert nm2.get(7).size == 99
    nm2.destroy()
    assert os.listdir(tmp_path) == []


def test_mmap_merge_amortization(tmp_path, monkeypatch):
    """Merges are ratio-amortized: N puts trigger O(log N) merges."""
    monkeypatch.setattr(pdense.MmapNeedleMap, "MERGE_THRESHOLD", 64)
    nm = pdense.MmapNeedleMap.load(io.BytesIO(), str(tmp_path / "a.mdx"), 4)
    n = 20_000
    for k in range(1, n + 1):
        nm.put(k, k * 8, 100)
    assert nm.merge_count <= 80, nm.merge_count
    assert nm.get(n).offset == n * 8 and nm.file_count() == n
    nm.release()


@pytest.mark.parametrize("kind", ["memory", "dense", "sqlite", "mmap"])
def test_volume_with_each_kind_reads_as_jax(kind, tmp_path):
    """A port volume's write/delete/compact cycle on each kind; a JAX volume
    of the same kind loads the files and reads the same needles, and so
    does the port after a reload."""
    d = str(tmp_path)
    v = PVolume(d, "", 1, needle_map_kind=kind)
    for i in range(1, 51):
        v.write_needle(PNeedle(cookie=0xAB, id=i, data=b"x" * (50 + i)))
    for i in range(1, 21):
        v.delete_needle(PNeedle(id=i, cookie=0xAB))
    v.compact()
    v.close()
    for volume_cls, needle_cls in ((JVolume, JNeedle), (PVolume, PNeedle)):
        v2 = volume_cls(d, "", 1, create_if_missing=False, needle_map_kind=kind)
        assert v2.file_count() == 30
        for i in range(21, 51):
            n = needle_cls(id=i)
            v2.read_needle(n)
            assert n.data == b"x" * (50 + i), (volume_cls, kind, i)
        for i in range(1, 21):
            with pytest.raises(Exception):
                v2.read_needle(needle_cls(id=i))
        v2.close()


def test_volume_sorted_kind_reads_sealed_volume(tmp_path):
    """The read-only sorted kind serves a sealed volume from its .sdx (made
    at load from the .idx, the same bytes as the JAX package's) and refuses
    writes; the JAX package's sorted volume reads the port's .sdx."""
    d = str(tmp_path)
    v = PVolume(d, "", 9, needle_map_kind="dense")
    for i in range(1, 31):
        v.write_needle(PNeedle(cookie=0xCD, id=i, data=b"s" * i))
    v.delete_needle(PNeedle(id=3, cookie=0xCD))
    v.close()
    v2 = PVolume(d, "", 9, create_if_missing=False, needle_map_kind="sorted")
    assert v2.read_only
    sdx = v2.file_name() + ".sdx"
    with open(v2.file_name() + ".idx", "rb") as f:
        jdense.write_sorted_index(f.read(), str(tmp_path / "want.sdx"))
    assert open(sdx, "rb").read() == (tmp_path / "want.sdx").read_bytes()
    n = PNeedle(id=10)
    v2.read_needle(n)
    assert n.data == b"s" * 10
    with pytest.raises((DeletedError, NotFoundError)):
        v2.read_needle(PNeedle(id=3))
    with pytest.raises(VolumeError):
        v2.write_needle(PNeedle(cookie=0xCD, id=99, data=b"nope"))
    assert v2.file_count() == 29
    v2.close()
    jv = JVolume(d, "", 9, create_if_missing=False, needle_map_kind="sorted")
    n = JNeedle(id=10)
    jv.read_needle(n)
    assert n.data == b"s" * 10 and jv.file_count() == 29
    jv.close()
