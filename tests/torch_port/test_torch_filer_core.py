"""The port's filer core held against the JAX package's, with no servers.

- ``filer/filechunks.py``: visible intervals, read views, compaction, the
  multi-chunk etag and the chunk difference equal on hypothesis chunk lists.
- ``filer/filechunk_manifest.py``: manifests byte-equal, packed and
  resolved the same.
- ``filer/entry.py``: an entry's dict round-trips through either package.
- ``filer/abstract_sql.py``: a ``filer.db`` written by either package reads
  in the other (entries, listings, KV).
- ``filer/meta_log.py``: segments written by either package replay in the
  other, and its sequence numbering resumes there.
- ``filer/filer_conf.py``: the same path rules match the same paths.
- ``filer/filer.py``: the same rename, link, overwrite and recursive-delete
  sequence gives equal listings, equal meta events and purges the same fids.
- ``filer/meta_aggregator.py``: the peer-signature prefix and the replay of
  a peer's events into a store.
"""

import json
import os

from hypothesis import given, settings
from hypothesis import strategies as st

from seaweedfs_tpu.filer import abstract_sql as j_sql
from seaweedfs_tpu.filer import entry as j_entry
from seaweedfs_tpu.filer import filechunk_manifest as j_man
from seaweedfs_tpu.filer import filechunks as j_fc
from seaweedfs_tpu.filer import filer as j_filer
from seaweedfs_tpu.filer import filer_conf as j_conf
from seaweedfs_tpu.filer import meta_aggregator as j_agg
from seaweedfs_tpu.filer import meta_log as j_log
from seaweedfs_tpu.filer import filerstore as j_store
from seaweedfs_tpu_torch.filer import abstract_sql as p_sql
from seaweedfs_tpu_torch.filer import entry as p_entry
from seaweedfs_tpu_torch.filer import filechunk_manifest as p_man
from seaweedfs_tpu_torch.filer import filechunks as p_fc
from seaweedfs_tpu_torch.filer import filer as p_filer
from seaweedfs_tpu_torch.filer import filer_conf as p_conf
from seaweedfs_tpu_torch.filer import meta_aggregator as p_agg
from seaweedfs_tpu_torch.filer import meta_log as p_log
from seaweedfs_tpu_torch.filer import filerstore as p_store

PKGS = {"jax": (j_entry, j_fc, j_man, j_sql, j_log, j_filer, j_store),
        "port": (p_entry, p_fc, p_man, p_sql, p_log, p_filer, p_store)}

chunk_tuples = st.lists(
    st.tuples(st.integers(0, 5000), st.integers(0, 3000), st.integers(0, 50),
              st.sampled_from(["", "a2V5"]), st.text("0123456789abcdef", max_size=8)),
    max_size=12)


def _chunks(mod, tuples):
    return [mod.FileChunk(file_id=f"{i % 7 + 1},{i:x}01020304", offset=o, size=s, mtime=m,
                          etag=e, cipher_key=k)
            for i, (o, s, m, k, e) in enumerate(tuples)]


def _plain(xs):
    return [x.__dict__ if hasattr(x, "__dict__") else
            {f: getattr(x, f) for f in x.__dataclass_fields__} for x in xs]


@settings(max_examples=150, deadline=None)
@given(chunk_tuples, st.integers(0, 6000), st.integers(0, 6000))
def test_filechunks_equal(tuples, offset, size):
    out = {}
    for kind, (entry, fc, *_rest) in PKGS.items():
        chunks = _chunks(entry, tuples)
        compacted, garbage = fc.compact_file_chunks(chunks)
        out[kind] = (
            _plain(fc.non_overlapping_visible_intervals(chunks)),
            _plain(fc.view_from_chunks(chunks, offset, size)),
            _plain(fc.view_from_chunks(chunks, offset, fc.MAX_INT64)),
            [c.to_dict() for c in compacted], [c.to_dict() for c in garbage],
            fc.etag_of_chunks(chunks) if chunks else None,
            fc.total_size(chunks),
            [c.to_dict() for c in fc.minus_chunks(chunks, chunks[::2])],
        )
    assert out["jax"] == out["port"]


@settings(max_examples=60, deadline=None)
@given(chunk_tuples, st.integers(1, 5))
def test_manifests_byte_equal(tuples, batch):
    blobs, out = {}, {}
    for kind, (entry, _fc, man, *_rest) in PKGS.items():
        saved = []

        def save(blob, entry=entry, saved=saved):
            saved.append(blob)
            return entry.FileChunk(file_id=f"9,{len(saved):x}0a0b0c0d", offset=0, size=0,
                                   mtime=len(saved))

        chunks = _chunks(entry, tuples)
        packed = man.maybe_manifestize(save, chunks, batch)
        store = dict(zip([c.file_id for c in packed if c.is_chunk_manifest], saved))
        resolved = man.resolve_chunk_manifest(lambda fid, key, store=store: store[fid], packed)
        blobs[kind] = (man.serialize_manifest(chunks), saved)
        out[kind] = ([c.to_dict() for c in packed], [c.to_dict() for c in resolved],
                     man.has_chunk_manifest(packed))
        assert [c.to_dict() for c in resolved] == [c.to_dict() for c in chunks]
    assert blobs["jax"] == blobs["port"]
    assert out["jax"] == out["port"]
    # a manifest blob one package wrote parses in the other
    assert [c.to_dict() for c in p_man.parse_manifest(blobs["jax"][0])] == \
        [c.to_dict() for c in j_man.parse_manifest(blobs["jax"][0])]


@settings(max_examples=60, deadline=None)
@given(st.text(min_size=1, max_size=12).map(lambda s: "/d/" + s.replace("/", "_")),
       st.booleans(), st.integers(0, 0o777), chunk_tuples,
       st.dictionaries(st.text(max_size=5), st.text(max_size=5), max_size=3))
def test_entry_dicts_round_trip(path, is_dir, mode, tuples, ext):
    d = j_entry.Entry(full_path=path, is_directory=is_dir, mode=mode, mtime=5, crtime=6,
                      chunks=_chunks(j_entry, tuples), extended=ext).to_dict()
    p = p_entry.Entry.from_dict(json.loads(json.dumps(d)))
    assert p.to_dict() == d
    assert j_entry.Entry.from_dict(p.to_dict()).to_dict() == d
    assert (p.name, p.parent, p.file_size()) == (
        j_entry.Entry.from_dict(d).name, j_entry.Entry.from_dict(d).parent,
        j_entry.Entry.from_dict(d).file_size())


def _fill_store(entry_mod, store):
    for i in range(30):
        store.insert_entry(entry_mod.Entry(
            full_path=f"/a/b{i % 3}/f{i:02d}", mtime=i, crtime=i,
            chunks=[entry_mod.FileChunk(file_id=f"3,{i:x}deadbeef", offset=0, size=i)]))
    store.insert_entry(entry_mod.Entry(full_path="/a/b1", is_directory=True, mtime=1, crtime=1))
    store.kv_put(b"filer.signature", b"12345")
    store.kv_put(b"\x00bin", b"\xff\x00")
    store.delete_entry("/a/b2/f05")


def _dump(store):
    out = []
    for d in ("/a/b0", "/a/b1", "/a/b2", "/a"):
        after = ""
        while True:
            page = list(store.list_entries(d, after, 4))
            out += [e.to_dict() for e in page]
            if len(page) < 4:
                break
            after = page[-1].name
    return out, store.find_entry("/a/b1/f04").to_dict(), store.kv_get(b"filer.signature"), \
        store.kv_get(b"\x00bin"), store.kv_get(b"nope")


def test_filer_db_interchanges(tmp_path):
    """One sqlite filer.db: written by either package, read by the other."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        db = str(tmp_path / f"{writer}.db")
        w_entry, w_sql = PKGS[writer][0], PKGS[writer][3]
        ws = w_sql.SqliteStore(db)
        _fill_store(w_entry, ws)
        want = _dump(ws)
        ws.close()
        rs = PKGS[reader][3].SqliteStore(db)
        try:
            assert _dump(rs) == want, (writer, reader)
            rs.delete_folder_children("/a/b0")
            assert list(rs.list_entries("/a/b0")) == []
        finally:
            rs.close()
    # the JAX package's and the port's schema are one
    import sqlite3

    schemas = []
    for kind in ("jax", "port"):
        con = sqlite3.connect(str(tmp_path / f"{kind}.db"))
        schemas.append(sorted(con.execute("SELECT name, sql FROM sqlite_master").fetchall()))
        con.close()
    assert schemas[0] == schemas[1]


def test_meta_log_segments_interchange(tmp_path):
    for writer, reader in (("jax", "port"), ("port", "jax")):
        d = str(tmp_path / writer)
        wlog = PKGS[writer][4].MetaLog(persist_dir=d, segment_events=3)
        for i in range(8):
            wlog.append(f"/dir{i}", None, {"full_path": f"/dir{i}/f"}, signatures=[i])
        want = [e.to_dict() for e in wlog.replay_since(0)]
        cut = want[2]["ts_ns"]
        wlog.close()
        rlog = PKGS[reader][4].MetaLog(persist_dir=d, segment_events=3)
        try:
            assert [e.to_dict() for e in rlog.replay_since(0)] == want
            assert [e.seq for e in rlog.replay_since(cut)] == [4, 5, 6, 7, 8]
            assert rlog.oldest_ts_ns() == 0
            ev = rlog.append("/x", None, {"full_path": "/x/y"})
            assert ev.seq == 9 and ev.ts_ns > want[-1]["ts_ns"]
        finally:
            rlog.close()
        assert sorted(os.listdir(d))[0] == "seg-00000000000000000001.jsonl"


def test_filer_conf_rules_match_alike():
    rules = {"locations": [
        {"location_prefix": "/buckets/", "collection": "b", "replication": "001"},
        {"location_prefix": "/buckets/hot/", "collection": "hot", "ttl": "1d"},
        {"location_prefix": "/logs", "collection": "logs", "fsync": True}]}
    data = json.dumps(rules).encode()
    jc, pc = j_conf.FilerConf.from_bytes(data), p_conf.FilerConf.from_bytes(data)
    for path in ("/", "/buckets/x", "/buckets/hot/y", "/buckets/hotter", "/logs/a", "/l"):
        assert jc.match_storage_rule(path).__dict__ == pc.match_storage_rule(path).__dict__
    assert jc.to_bytes() == pc.to_bytes()
    assert j_conf.FILER_CONF_PATH == p_conf.FILER_CONF_PATH


def _drive(kind):
    """One sequence of filer operations; (listings, normalized events,
    purged fids)."""
    entry, *_, filer_mod, store_mod = PKGS[kind]
    purged = []
    f = filer_mod.Filer(store=store_mod.MemoryStore(), chunk_purger=purged.extend)

    def put(path, fids, size=10):
        f.create_entry(entry.Entry(full_path=path, mtime=1, crtime=1, chunks=[
            entry.FileChunk(file_id=fid, offset=i * size, size=size, mtime=i + 1)
            for i, fid in enumerate(fids)]))

    put("/t/a/one", ["1,a1"])
    put("/t/a/two", ["1,b1", "1,b2"])
    put("/t/a/deep/three", ["2,c1"])
    put("/t/a/one", ["1,a2"])  # overwrite: 1,a1 is garbage
    f.rename("/t/a/deep", "/t/moved")
    f.link("/t/a/two", "/t/b/two-link")
    put("/t/b/two-link", ["3,d1"])  # through the link: the inode's chunks go
    f.delete_entry("/t/a/one")
    try:
        f.delete_entry("/t/a")
    except OSError:
        pass
    f.delete_entry("/t/a", recursive=True)
    f.delete_entry("/t/moved", recursive=True, skip_chunk_purge=True)
    listing = {d: [(e.name, e.is_directory, [c.file_id for c in e.chunks])
                   for e in f.list_entries(d)] for d in ("/", "/t", "/t/b")}
    events = [(e.directory, (e.old_entry or {}).get("full_path"),
               (e.new_entry or {}).get("full_path"), e.delete_chunks, e.seq)
              for e in f.meta_log.replay_since(0)]
    return listing, events, sorted(purged)


def test_filer_rename_link_delete_collect_the_same_fids():
    j, p = _drive("jax"), _drive("port")
    assert j == p
    assert "1,a1" in p[2] and "2,c1" not in p[2]


def test_meta_aggregator_signature_prefix_and_replay():
    assert p_agg.PEER_SIG_PREFIX == j_agg.PEER_SIG_PREFIX
    stores = {"jax": j_store.MemoryStore(), "port": p_store.MemoryStore()}
    log = p_log.MetaLog()
    e1 = {"full_path": "/r/x", "is_directory": False, "chunks": [], "mtime": 3, "crtime": 3}
    evs = [log.append("/r", None, e1), log.append("/r", e1, dict(e1, mime="text/plain")),
           log.append("/r", dict(e1, mime="text/plain"), None)]
    for ev in evs[:2]:
        j_agg.apply_event_to_store(stores["jax"], j_log.EventNotification.from_dict(ev.to_dict()))
        p_agg.apply_event_to_store(stores["port"], ev)
    assert stores["jax"].find_entry("/r/x").to_dict() == stores["port"].find_entry("/r/x").to_dict()
    j_agg.apply_event_to_store(stores["jax"], j_log.EventNotification.from_dict(evs[2].to_dict()))
    p_agg.apply_event_to_store(stores["port"], evs[2])
    assert list(stores["port"].list_entries("/r")) == list(stores["jax"].list_entries("/r")) == []
