"""Filer core: path→Entry CRUD with parent-dir auto-creation + deletion GC.

Mirrors `weed/filer/filer.go:30-253` + `filer_delete_entry.go`: creates
missing parent directories on insert, recursive delete collects chunk fids
for the deletion queue, every mutation notifies the meta log.

The port's copy of the JAX package's ``filer/filer.py``.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional

from ..util import faultpoints, glog
from ..util.locks import make_rlock
from .entry import Entry, FileChunk
from .filechunks import compact_file_chunks, minus_chunks
from .filerstore import FilerStore, MemoryStore, NotFoundError
from .meta_log import MetaLog

# purge(fids) — wired to operation.delete_files by the daemon
ChunkPurger = Callable[[list[str]], None]


class Filer:
    def __init__(
        self,
        store: Optional[FilerStore] = None,
        chunk_purger: Optional[ChunkPurger] = None,
        meta_log_dir: Optional[str] = None,
    ):
        self.store = store or MemoryStore()
        self.meta_log = MetaLog(persist_dir=meta_log_dir)
        self.chunk_purger = chunk_purger
        # expands manifest chunks into their children before purging so
        # chunk-of-chunks files don't leak data chunks on delete/overwrite
        # (filer_delete_entry.go ResolveChunkManifest); the server wires a
        # resolver that can actually read manifest blobs
        self.chunk_resolver: Optional[Callable[[list], list]] = None
        self._lock = make_rlock("Filer._lock")
        self._ensure_root()

    def _fids(self, chunks) -> list[str]:
        if self.chunk_resolver is not None:
            try:
                resolved = self.chunk_resolver(chunks)
                # manifest fids themselves are garbage too
                return [c.file_id for c in chunks] + [
                    c.file_id
                    for c in resolved
                    if c.file_id not in {x.file_id for x in chunks}
                ]
            except Exception:
                # fall back: purge at least the listed fids; the manifest
                # chunks themselves become unreferenced garbage, so say so
                glog.V(1).info("manifest resolve failed; purging %d listed"
                               " fids only", len(chunks))
        return [c.file_id for c in chunks]

    def _ensure_root(self) -> None:
        try:
            self.store.find_entry("/")
        except NotFoundError:
            self.store.insert_entry(
                Entry(full_path="/", is_directory=True, mode=0o755)
            )

    # -- CRUD (filer.go:131-253) ---------------------------------------------
    def create_entry(
        self,
        entry: Entry,
        o_excl: bool = False,
        signatures: Optional[list[int]] = None,
    ) -> Entry:
        with self._lock:
            # the per-filer serialization point: a delay armed here models
            # a loaded metadata store
            faultpoints.fire("filer.meta.create", path=entry.full_path)
            self._ensure_parents(entry.parent)
            old = None
            try:
                old = self.store.find_entry(entry.full_path)
            except NotFoundError:
                pass
            if old is not None:
                if o_excl:
                    raise FileExistsError(entry.full_path)
                if old.is_directory and not entry.is_directory:
                    raise IsADirectoryError(entry.full_path)
                if old.is_directory and entry.is_directory:
                    # re-mkdir is a no-op and emits NO meta event: a
                    # replicated mkdir would otherwise echo between
                    # active-active clusters forever — each apply raising
                    # a fresh event the other side re-applies
                    return old
            if old is not None and old.hard_link_id and not entry.hard_link_id:
                # writing through a linked path updates the shared inode so
                # every link sees the new content (filerstore_hardlink.go)
                inode = self._resolve_hardlink(old)
                counter = inode.hard_link_counter
                entry.hard_link_id = old.hard_link_id
                self._write_hardlink_content(old.hard_link_id, entry, counter)
                old = inode  # garbage math uses the inode's real chunks
                self.meta_log.append(
                    entry.parent, old.to_dict(), entry.to_dict(),
                    signatures=signatures,
                )
                if old.chunks and self.chunk_purger:
                    garbage = minus_chunks(old.chunks, entry.chunks)
                    if garbage:
                        self.chunk_purger(self._fids(garbage))
                return entry
            self.store.insert_entry(entry)
        self.meta_log.append(
            entry.parent,
            old.to_dict() if old else None,
            entry.to_dict(),
            signatures=signatures,
        )
        # chunks shadowed by the overwrite become garbage
        if old is not None and old.chunks and self.chunk_purger:
            garbage = minus_chunks(old.chunks, entry.chunks)
            if garbage:
                self.chunk_purger(self._fids(garbage))
        return entry

    def _ensure_parents(self, dir_path: str) -> None:
        if dir_path == "/":
            return
        try:
            e = self.store.find_entry(dir_path)
            if not e.is_directory:
                raise NotADirectoryError(dir_path)
            return
        except NotFoundError:
            pass
        parent = dir_path.rsplit("/", 1)[0] or "/"
        self._ensure_parents(parent)
        d = Entry(full_path=dir_path, is_directory=True, mode=0o775)
        self.store.insert_entry(d)
        self.meta_log.append(parent, None, d.to_dict())

    # -- hardlinks (filer/filerstore_hardlink.go) ----------------------------
    # Linked paths are stubs carrying a hard_link_id; the shared "inode"
    # (attrs + chunk list + link counter) lives in the store's KV under
    # hardlink/<id>, so a write through any path is seen by all of them.
    _HARDLINK_KV = b"hardlink/"

    def _hardlink_key(self, hid: str) -> bytes:
        return self._HARDLINK_KV + hid.encode()

    def _resolve_hardlink(self, entry: Entry) -> Entry:
        if not entry.hard_link_id:
            return entry
        import json as _json

        raw = self.store.kv_get(self._hardlink_key(entry.hard_link_id))
        if not raw:
            return entry  # dangling stub: serve as-is
        content = _json.loads(raw)
        resolved = Entry.from_dict(content | {"full_path": entry.full_path})
        resolved.hard_link_id = entry.hard_link_id
        resolved.hard_link_counter = content.get("hard_link_counter", 1)
        return resolved

    def _write_hardlink_content(self, hid: str, entry: Entry, counter: int) -> None:
        import json as _json

        content = entry.to_dict()
        content["hard_link_counter"] = counter
        self.store.kv_put(self._hardlink_key(hid), _json.dumps(content).encode())

    def link(self, target_path: str, link_path: str) -> Entry:
        """Create a hardlink at link_path referencing target_path's inode
        (filer_grpc_server link handling for mount's Link op)."""
        import secrets as _secrets

        with self._lock:
            raw = self.store.find_entry(target_path)
            if raw.is_directory:
                raise IsADirectoryError(target_path)
            if raw.hard_link_id:
                hid = raw.hard_link_id
                inode = self._resolve_hardlink(raw)
                counter = inode.hard_link_counter + 1
            else:
                hid = _secrets.token_hex(8)
                inode = raw
                counter = 2
                stub = Entry(full_path=target_path)
                stub.hard_link_id = hid
                stub.mode = raw.mode
                self.store.update_entry(stub)
            self._write_hardlink_content(hid, inode, counter)
            link_stub = Entry(full_path=link_path)
            link_stub.hard_link_id = hid
            link_stub.mode = inode.mode
            self._ensure_parents(link_stub.parent)
            self.store.insert_entry(link_stub)
        resolved = self._resolve_hardlink(link_stub)
        self.meta_log.append(link_stub.parent, None, resolved.to_dict())
        return resolved

    def find_entry(self, path: str) -> Entry:
        return self._resolve_hardlink(self.store.find_entry(path))

    def update_entry(self, entry: Entry) -> Entry:
        with self._lock:
            old = self.store.find_entry(entry.full_path)  # must exist
            self.store.update_entry(entry)
        self.meta_log.append(entry.parent, old.to_dict(), entry.to_dict())
        return entry

    def append_chunks(self, path: str, chunks: list[FileChunk]) -> Entry:
        """AppendToEntry semantics (filer_grpc_server.go)."""
        with self._lock:
            try:
                entry = self.store.find_entry(path)
            except NotFoundError:
                entry = Entry(full_path=path)
            offset = entry.file_size()
            for c in chunks:
                c.offset = offset
                offset += c.size
            entry.chunks.extend(chunks)
            entry.mtime = int(time.time())
            return self.create_entry(entry)

    def delete_entry(
        self,
        path: str,
        recursive: bool = False,
        ignore_recursive_error: bool = False,
        skip_chunk_purge: bool = False,
        signatures: Optional[list[int]] = None,
    ) -> list[str]:
        """Returns the chunk fids queued for purging
        (filer_delete_entry.go:15). Chunks are purged once, at the top level.
        `skip_chunk_purge` drops the metadata but keeps the chunks — used when
        chunk ownership moved to another entry (S3 multipart complete,
        filer_multipart.go)."""
        fids = self._delete_entry(
            path, recursive, ignore_recursive_error, signatures
        )
        if fids and self.chunk_purger and not skip_chunk_purge:
            self.chunk_purger(fids)
        return fids

    def _delete_entry(
        self,
        path: str,
        recursive: bool,
        ignore_recursive_error: bool,
        signatures: Optional[list[int]] = None,
    ) -> list[str]:
        with self._lock:
            entry = self.store.find_entry(path)
            fids = []
            if entry.hard_link_id:
                # unlink: drop the stub, decrement the inode's counter;
                # chunks are purged only when the last link goes away. The
                # counter read-modify-write and the inode content update
                # must be serialized with create_entry/link through other
                # link paths (two racing unlinks would otherwise both read
                # the same counter and leak the chunks forever).
                hid = entry.hard_link_id
                inode = self._resolve_hardlink(entry)
                counter = inode.hard_link_counter - 1
                self.store.delete_entry(path)
                if counter <= 0:
                    self.store.kv_put(self._hardlink_key(hid), b"")
                    fids = self._fids(inode.chunks)
                else:
                    self._write_hardlink_content(hid, inode, counter)
                self.meta_log.append(
                    entry.parent,
                    inode.to_dict() | {"full_path": path},
                    None,
                    delete_chunks=bool(fids),
                    signatures=signatures,
                )
                return fids
            if entry.is_directory:
                children = list(self.store.list_entries(path, limit=1_000_000))
                if children and not recursive:
                    raise OSError(f"directory {path} not empty")
                for child in children:
                    try:
                        fids.extend(
                            self._delete_entry(
                                child.full_path, True, ignore_recursive_error, signatures
                            )
                        )
                    except Exception:
                        if not ignore_recursive_error:
                            raise
            fids.extend(self._fids(entry.chunks))
            self.store.delete_entry(path)
        self.meta_log.append(
            entry.parent,
            entry.to_dict(),
            None,
            delete_chunks=bool(fids),
            signatures=signatures,
        )
        return fids

    def list_entries(
        self, dir_path: str, start_after: str = "", limit: int = 1000
    ) -> Iterator[Entry]:
        for e in self.store.list_entries(dir_path, start_after, limit):
            yield self._resolve_hardlink(e)

    # -- maintenance ---------------------------------------------------------
    def compact_chunks(self, path: str) -> int:
        """Drop fully-shadowed chunks from an entry; purge them. Returns the
        number of garbage chunks removed."""
        entry = self.store.find_entry(path)
        compacted, garbage = compact_file_chunks(entry.chunks)
        if garbage:
            entry.chunks = compacted
            self.store.update_entry(entry)
            if self.chunk_purger:
                self.chunk_purger(self._fids(garbage))
        return len(garbage)

    def rename(self, old_path: str, new_path: str) -> Entry:
        """AtomicRenameEntry for files and (recursively) directories."""
        with self._lock:
            entry = self.store.find_entry(old_path)
            if entry.is_directory:
                for child in list(self.store.list_entries(old_path, limit=1_000_000)):
                    self.rename(
                        child.full_path, new_path + "/" + child.name
                    )
            # an overwritten destination's chunks become garbage
            displaced: list[str] = []
            try:
                dest = self.store.find_entry(new_path)
                displaced = self._fids(minus_chunks(dest.chunks, entry.chunks))
            except NotFoundError:
                pass
            new_entry = Entry.from_dict(entry.to_dict())
            new_entry.full_path = new_path
            self._ensure_parents(new_entry.parent)
            self.store.insert_entry(new_entry)
            self.store.delete_entry(old_path)
        self.meta_log.append(entry.parent, entry.to_dict(), new_entry.to_dict())
        if displaced and self.chunk_purger:
            self.chunk_purger(displaced)
        return new_entry
