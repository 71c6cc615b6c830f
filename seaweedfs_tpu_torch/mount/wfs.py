"""WFS: the virtual filesystem over the filer. The port's copy of the JAX
package's ``mount/wfs.py``.

Reference: `weed/filesys/wfs.go:55` (the FUSE fs object), `file.go`/
`filehandle.go` (open-file state + dirty pages), `wfs_write.go`
(saveDataAsChunk: assign fid → upload → append chunk), `dir.go`
(directory ops). ``fuse_mount.FuseMount`` is the thin FUSE adapter over it.

Write path: writes land in ContinuousIntervals; any continuous run that
reaches chunk_size is eagerly uploaded and committed; flush() uploads the
rest and commits the entry (chunk list) to the filer. Read path: committed
bytes come from the filer (ranged GET), then still-dirty intervals overlay
them — read-your-writes without waiting for a flush. The entries it
commits (chunks, xattrs under ``xattr-``) are the JAX package's, so either
package's WFS reads the other's tree.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .. import operation
from ..filer.client import FilerClient  # noqa: F401 — re-exported for callers
from ..filer.entry import Entry, FileChunk
from .dirty_pages import ContinuousIntervals
from .meta_cache import MetaCache


class WfsError(Exception):
    pass


class WFS:
    def __init__(
        self,
        filer_url: str,
        chunk_size: int = 8 * 1024 * 1024,
        collection: str = "",
        ttl: str = "",
        meta_cache_db: str = ":memory:",
        use_meta_cache: bool = True,
        cipher: Optional[bool] = None,
        read_window: int = 4,
        write_window: int = 4,
    ):
        # multi-address lists route entry commits by ring ownership —
        # direct-to-volume data writes are unaffected, but the COMMIT
        # (create_entry) must land on the path's owning filer
        from ..filer.ring import make_client

        self.client = make_client(filer_url)
        self.chunk_size = chunk_size
        self.collection = collection
        self.ttl = ttl
        # data-plane pipeline depths (util/pipeline.py): bounded windows of
        # concurrent chunk uploads / ranged sub-reads per operation. Peak
        # extra memory per call is window × chunk_size (util/pipeline.py).
        self.read_window = max(1, read_window)
        self.write_window = max(1, write_window)
        if cipher is None:
            # honor the filer's -encryptVolumeData setting the way the
            # reference mount reads GetFilerConfiguration (wfs.go:55) —
            # otherwise every mount write silently bypasses encryption
            try:
                cipher = bool(self.client.status().get("cipher", False))
            except Exception:
                cipher = False
        self.cipher = cipher
        self.meta_cache: Optional[MetaCache] = None
        if use_meta_cache:
            self.meta_cache = MetaCache(filer_url, meta_cache_db).start()

    def close(self) -> None:
        if self.meta_cache:
            self.meta_cache.stop()

    # -- directory ops (filesys/dir.go) --------------------------------------
    def stat(self, path: str) -> Entry:
        e = (
            self.meta_cache.lookup(path)
            if self.meta_cache
            else self._remote_entry(path)
        )
        if e is None:
            raise FileNotFoundError(path)
        return e

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except FileNotFoundError:
            return False

    def _remote_entry(self, path: str) -> Optional[Entry]:
        d = self.client.get_entry(path)
        return Entry.from_dict(d) if d else None

    def listdir(self, path: str) -> list[Entry]:
        if self.meta_cache:
            return self.meta_cache.list_dir(path)
        return [Entry.from_dict(d) for d in self.client.list(path)]

    def mkdir(self, path: str, mode: int = 0o775) -> None:
        self.client.mkdir(path)
        if self.meta_cache:
            self.meta_cache.invalidate(path)

    def unlink(self, path: str) -> None:
        self.client.delete(path)
        if self.meta_cache:
            self.meta_cache.invalidate(path)

    def rmdir(self, path: str, recursive: bool = False) -> None:
        self.client.delete(path, recursive=recursive)
        if self.meta_cache:
            self.meta_cache.invalidate(path)

    def rename(self, old: str, new: str) -> None:
        self.client.rename(old, new)
        if self.meta_cache:
            self.meta_cache.invalidate(old)
            self.meta_cache.invalidate(new)

    # -- xattr (filesys/xattr.go — entry.Extended carries them) --------------
    XATTR_PREFIX = "xattr-"

    def _commit_meta(self, path: str, entry: Entry) -> None:
        self.client.create_entry(path, entry.to_dict())
        if self.meta_cache:
            self.meta_cache.invalidate(path)

    @property
    def _meta_mu(self):
        """Serializes every read-modify-write entry upsert in this process
        (xattr mutations vs FileHandle chunk commits): two interleaved
        fetch→commit cycles would otherwise revert each other's half —
        a metadata write must never be able to truncate a flushed chunk
        list. Cross-process writers race at the filer like the reference's
        mounts do; in-process is the case the kernel actually produces."""
        mu = getattr(self, "_meta_mu_", None)
        if mu is None:
            mu = self._meta_mu_ = threading.Lock()
        return mu

    def _xattr_gen(self, path: str) -> int:
        return getattr(self, "_ext_gens_", {}).get(path, 0)

    def _bump_xattr_gen(self, path: str) -> None:
        gens = getattr(self, "_ext_gens_", None)
        if gens is None:
            gens = self._ext_gens_ = {}
        gens[path] = gens.get(path, 0) + 1

    def setxattr(self, path: str, name: str, value: bytes,
                 create: bool = False, replace: bool = False) -> None:
        import base64
        import errno

        with self._meta_mu:
            # always the LIVE entry, never a cache: a concurrent flush may
            # have just committed fresh chunks, and upserting a stale chunk
            # list here would truncate the file's new data
            entry = self._remote_entry(path)
            if entry is None:
                raise FileNotFoundError(path)
            ext = dict(entry.extended or {})
            key = self.XATTR_PREFIX + name
            if create and key in ext:
                raise FileExistsError(name)
            if replace and key not in ext:
                raise OSError(errno.ENODATA, name)
            ext[key] = base64.b64encode(value).decode()
            entry.extended = ext
            self._bump_xattr_gen(path)
            self._commit_meta(path, entry)

    def getxattr(self, path: str, name: str) -> bytes:
        import base64
        import errno

        entry = self.stat(path)
        raw = (entry.extended or {}).get(self.XATTR_PREFIX + name)
        if raw is None:
            raise OSError(errno.ENODATA, name)
        return base64.b64decode(raw)

    def listxattr(self, path: str) -> list[str]:
        entry = self.stat(path)
        pre = self.XATTR_PREFIX
        return sorted(
            k[len(pre):] for k in (entry.extended or {}) if k.startswith(pre)
        )

    def removexattr(self, path: str, name: str) -> None:
        import errno

        with self._meta_mu:
            entry = self._remote_entry(path)  # live, not cached (setxattr)
            if entry is None:
                raise FileNotFoundError(path)
            ext = dict(entry.extended or {})
            if ext.pop(self.XATTR_PREFIX + name, None) is None:
                raise OSError(errno.ENODATA, name)
            entry.extended = ext
            self._bump_xattr_gen(path)
            self._commit_meta(path, entry)

    # -- file ops ------------------------------------------------------------
    def open(self, path: str, mode: str = "r") -> "FileHandle":
        """Modes: r, r+, w (truncate/create), a (append/create)."""
        entry: Optional[Entry] = None
        try:
            entry = self.stat(path)
        except FileNotFoundError:
            pass
        if mode in ("r", "r+") and entry is None:
            raise FileNotFoundError(path)
        if entry is not None and entry.is_directory:
            raise IsADirectoryError(path)
        if mode == "w" or entry is None:
            entry = Entry(full_path=path, is_directory=False, mode=0o660)
            entry.chunks = []
            if mode in ("w", "a", "r+"):
                # commit the (possibly truncating) create immediately so
                # concurrent readers see a consistent entry
                self.client.create_entry(path, entry.to_dict())
                if self.meta_cache:
                    self.meta_cache.invalidate(path)
        return FileHandle(self, path, entry, mode)

    # convenience one-shots
    def write_file(self, path: str, data: bytes) -> None:
        with self.open(path, "w") as f:
            f.write(0, data)

    def read_file(self, path: str) -> bytes:
        with self.open(path, "r") as f:
            return f.read(0, f.size())

    # -- chunk upload (wfs_write.go saveDataAsChunk) -------------------------
    def _save_one_chunk(self, piece: bytes, chunk_offset: int) -> FileChunk:
        a = self.client.assign(collection=self.collection, ttl=self.ttl)
        if a.get("error"):
            raise WfsError(f"assign: {a['error']}")
        payload, cipher_key_b64 = piece, ""
        if self.cipher:
            # fresh key per chunk; the volume stores ciphertext and the
            # entry holds the key, same as filer POST (_write_cipher.go)
            import base64

            from ..util import cipher as cipher_mod

            key = cipher_mod.gen_cipher_key()
            payload = cipher_mod.encrypt(piece, key)
            cipher_key_b64 = base64.b64encode(key).decode()
        operation.upload_data(a["url"], a["fid"], payload, jwt=a.get("auth", ""))
        return FileChunk(
            file_id=a["fid"],
            offset=chunk_offset,
            size=len(piece),
            mtime=time.time_ns(),
            cipher_key=cipher_key_b64,
        )

    def save_data_as_chunks(self, data: bytes, base_offset: int) -> list[FileChunk]:
        """Assign+encrypt+upload each chunk_size piece; multi-piece runs go
        through a bounded window of concurrent uploads so chunk k+1 is on
        the wire while chunk k finishes (wfs_write.go saveDataAsChunk under
        concurrentWriters). Chunk order in the returned list is piece
        order; on any failure the window is settled before raising — like
        the reference mount, already-uploaded pieces of an uncommitted run
        are leaked to the volume (vacuum reclaims them), never committed."""
        pieces = [
            (data[pos : pos + self.chunk_size], base_offset + pos)
            for pos in range(0, len(data), self.chunk_size)
        ]
        if len(pieces) <= 1 or self.write_window <= 1:
            return [self._save_one_chunk(p, off) for p, off in pieces]
        from ..util.pipeline import BoundedExecutor

        pipe = BoundedExecutor(self.write_window, name="wfs-write")
        try:
            for piece, off in pieces:
                pipe.submit(self._save_one_chunk, piece, off)
        except BaseException:
            pipe.abort()  # settle in-flight uploads, then surface the error
            raise
        return pipe.drain()  # submit order == piece order


class FileHandle:
    """Open-file state (filesys/filehandle.go): dirty pages + entry view."""

    def __init__(self, wfs: WFS, path: str, entry: Entry, mode: str):
        self.wfs = wfs
        self.path = path
        self.entry = entry
        self.mode = mode
        self.dirty = ContinuousIntervals()
        self._lock = threading.RLock()
        self._closed = False

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "FileHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def size(self) -> int:
        with self._lock:
            return max(self.entry.file_size(), self.dirty.max_stop())

    def append_offset(self) -> int:
        return self.size()

    # -- write path ----------------------------------------------------------
    def write(self, offset: int, data: bytes) -> int:
        if self.mode == "r":
            raise WfsError("file not open for writing")
        with self._lock:
            if self.mode == "a":
                offset = self.size()
            self.dirty.add_interval(offset, data, time.time_ns())
            # eager flush of full chunk runs (dirty_pages.go)
            while True:
                iv = self.dirty.pop_largest_if_over(self.wfs.chunk_size)
                if iv is None:
                    break
                self._commit_chunks(
                    self.wfs.save_data_as_chunks(iv.data, iv.start)
                )
            return len(data)

    def _commit_chunks(self, new_chunks: list[FileChunk]) -> None:
        with self.wfs._meta_mu:  # vs concurrent xattr read-modify-writes
            self.entry.chunks.extend(new_chunks)
            self.entry.mtime = int(time.time())
            # refresh the extended map before upserting — but only when an
            # xattr mutation actually happened on this path (generation
            # counter), so plain writes don't pay a fetch per flush. An
            # xattr set while this handle was open must not be clobbered
            # by the open-time snapshot; the handle never mutates extended.
            if self.wfs._xattr_gen(self.path):
                remote = self.wfs._remote_entry(self.path)
                if remote is not None:
                    self.entry.extended = dict(remote.extended or {})
            self.wfs._commit_meta(self.path, self.entry)

    def flush(self) -> None:
        with self._lock:
            ivs = self.dirty.pop_all()
            if not ivs:
                return
            chunks: list[FileChunk] = []
            for iv in ivs:
                chunks.extend(self.wfs.save_data_as_chunks(iv.data, iv.start))
            self._commit_chunks(chunks)

    def truncate(self, length: int = 0) -> None:
        """Truncate-to-zero drops all chunks; extension is logical;
        mid-file truncation keeps the [0, length) prefix by re-writing it
        as fresh chunks (correct for cipher'd chunks too, since the read
        path decrypts — chunk-clipping in metadata alone would not be).

        The prefix chunks are UPLOADED BEFORE the entry commit: a failure
        anywhere leaves the old entry (and the data) intact instead of
        committing an emptied chunk list first and losing the file."""
        with self._lock:  # RLock: read() below re-enters; holding it across
            # the whole operation keeps a concurrent acknowledged write from
            # landing between the prefix snapshot and the commit
            new_chunks: list[FileChunk] = []
            if length > 0:
                if length >= self.size():
                    return  # logical extension / no-op
                prefix = self.read(0, length)
                new_chunks = self.wfs.save_data_as_chunks(prefix, 0)
            self.dirty = ContinuousIntervals()
            self.entry.chunks = new_chunks
            self.wfs.client.create_entry(self.path, self.entry.to_dict())
            if self.wfs.meta_cache:
                self.wfs.meta_cache.invalidate(self.path)

    def _read_committed(self, lo: int, hi: int) -> bytes:
        """Fetch committed bytes [lo, hi] inclusive from the filer. Spans
        larger than one chunk split into chunk_size sub-ranges pulled
        through a read_window-deep prefetcher (util/pipeline.py) — each
        worker holds its own pooled keep-alive socket to the filer, so a
        big mount read rides several connections while this thread
        reassembles them in order."""
        from ..util.pipeline import prefetch_iter

        step = self.wfs.chunk_size
        spans = [
            (s, min(s + step - 1, hi)) for s in range(lo, hi + 1, step)
        ]

        def fetch(span):
            s, e = span
            status, data, _ = self.wfs.client.get_object(
                self.path, rng=f"bytes={s}-{e}"
            )
            if status not in (200, 206):
                raise WfsError(f"read {self.path}: HTTP {status}")
            return data

        window = self.wfs.read_window if len(spans) > 1 else 1
        out = bytearray(hi - lo + 1)
        pos = 0
        fetched = prefetch_iter(spans, fetch, window)
        try:
            for _, data in fetched:
                out[pos : pos + len(data)] = data
                pos += len(data)
        finally:
            fetched.close()
        return bytes(out[:pos])

    # -- read path -----------------------------------------------------------
    def read(self, offset: int, size: int) -> bytes:
        with self._lock:
            end = min(offset + size, self.size())
            if end <= offset:
                return b""
            want = end - offset
            base = bytearray(want)
            committed = self.entry.file_size()
            if offset < committed:
                hi = min(end, committed) - 1
                data = self._read_committed(offset, hi)
                base[: len(data)] = data
            # overlay still-dirty bytes (read-your-writes)
            for lo, data in self.dirty.read_data_at(offset, want):
                base[lo - offset : lo - offset + len(data)] = data
            return bytes(base)

    def close(self) -> None:
        if not self._closed:
            self.flush()
            self._closed = True
