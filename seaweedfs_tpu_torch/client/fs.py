"""fsspec ``AbstractFileSystem`` over the filer's HTTP API: the port of the
JAX package's ``client/fs.py``.

The reference's HDFS adapter (`other/java/hdfs2/.../SeaweedFileSystem.java`)
maps Hadoop ``FileSystem`` calls onto the filer, streaming file bytes chunk
by chunk to the volume servers (`SeaweedOutputStream.java`) and reading with
ranged chunk views (`SeaweedInputStream.java`). The same design here:

- reads: ranged GETs against the filer;
- writes: chunk-size pieces are assigned through the filer's ``/_assign``
  and uploaded straight to the volume servers (encrypted when the filer
  runs ``-encryptVolumeData``), and the entry (its chunk list) is committed
  to the filer on close;
- listings and metadata: the filer's JSON listing and ``?meta=true``.

``filer`` is one filer's address, or a comma list of a filer fleet's members
(``filer/ring.make_client`` gives a ``RingFilerClient`` for those).

``fsspec`` is imported on first use: ``SeaweedFileSystem`` and
``SeaweedFile`` are built when first looked up (a module ``__getattr__``),
so importing this module needs no fsspec.
"""

from __future__ import annotations

import base64
import time
from typing import Optional
from urllib.parse import urlsplit

from .. import operation
from ..filer.client import FilerClient  # noqa: F401 — re-exported for callers
from ..filer.entry import Entry, FileChunk
from ..filer.ring import make_client
from ..util import cipher as cipher_mod
from ..util.pipeline import BoundedExecutor


def _entry_info(d: dict, path: str) -> dict:
    e = Entry.from_dict(d) if "full_path" in d else None
    size = e.file_size() if e else d.get("size", 0)
    is_dir = d.get("is_directory", False)
    return {
        # absolute names, as the local and hdfs fsspec implementations give
        # (pyarrow datasets rely on ls names lying inside the base dir)
        "name": path,
        "size": 0 if is_dir else size,
        "type": "directory" if is_dir else "file",
        "mtime": d.get("mtime", 0),
        "mode": d.get("mode", 0o660),
        "mime": d.get("mime", ""),
        "collection": d.get("collection", ""),
    }


class ChunkWriter:
    """Assign, encrypt and upload chunk-size pieces straight to the volume
    servers (the JAX package's ``mount/wfs.WFS.save_data_as_chunks``, whose
    mount is not ported yet): runs of several pieces go through a bounded
    window of concurrent uploads, and the chunks come back in piece order.
    A failed run leaks its uploaded pieces to the volume (vacuum reclaims
    them); nothing is committed."""

    def __init__(self, client, chunk_size: int, collection: str = "",
                 ttl: str = "", cipher: bool = False, write_window: int = 4):
        self.client = client
        self.chunk_size = chunk_size
        self.collection = collection
        self.ttl = ttl
        self.cipher = cipher
        self.write_window = max(1, write_window)

    def _save_one_chunk(self, piece: bytes, chunk_offset: int) -> FileChunk:
        a = self.client.assign(collection=self.collection, ttl=self.ttl)
        if a.get("error"):
            raise OSError(f"assign: {a['error']}")
        payload, cipher_key_b64 = piece, ""
        if self.cipher:
            # a fresh key per chunk: the volume stores ciphertext, the entry
            # holds the key, as the filer's own cipher'd POST does
            key = cipher_mod.gen_cipher_key()
            payload = cipher_mod.encrypt(piece, key)
            cipher_key_b64 = base64.b64encode(key).decode()
        operation.upload_data(a["url"], a["fid"], payload, jwt=a.get("auth", ""))
        return FileChunk(file_id=a["fid"], offset=chunk_offset, size=len(piece),
                         mtime=time.time_ns(), cipher_key=cipher_key_b64)

    def save_data_as_chunks(self, data: bytes, base_offset: int) -> list[FileChunk]:
        pieces = [(data[pos:pos + self.chunk_size], base_offset + pos)
                  for pos in range(0, len(data), self.chunk_size)]
        if len(pieces) <= 1 or self.write_window <= 1:
            return [self._save_one_chunk(p, off) for p, off in pieces]
        pipe = BoundedExecutor(self.write_window, name="fs-write")
        try:
            for piece, off in pieces:
                pipe.submit(self._save_one_chunk, piece, off)
        except BaseException:
            pipe.abort()  # settle the uploads in flight, then raise
            raise
        return pipe.drain()  # submit order is piece order


def _build_classes():
    from fsspec import AbstractFileSystem
    from fsspec.spec import AbstractBufferedFile

    class SeaweedFileSystem(AbstractFileSystem):
        """``fsspec.filesystem("seaweedfs", filer="host:port")``: the
        operation set of `SeaweedFileSystem.java` (mkdirs, open, create,
        rename, delete, listStatus, getFileStatus) under fsspec's names."""

        protocol = ("seaweedfs", "swfs")
        root_marker = "/"

        def __init__(self, filer: str = "127.0.0.1:8888",
                     chunk_size: int = 8 * 1024 * 1024, collection: str = "",
                     ttl: str = "", cipher: Optional[bool] = None, **kwargs):
            super().__init__(**kwargs)
            self.filer = filer
            self.client = make_client(filer)
            self.chunk_size = chunk_size
            self.collection = collection
            self.ttl = ttl
            if cipher is None:
                # honour the filer's -encryptVolumeData as the mount does: a
                # direct-to-volume writer that skipped it would store plaintext
                try:
                    cipher = bool(self.client.status().get("cipher", False))
                except Exception:  # noqa: BLE001 — an unreachable filer: no cipher
                    cipher = False
            self.cipher = cipher
            self._writer: Optional[ChunkWriter] = None

        # -- path/url plumbing ---------------------------------------------
        @classmethod
        def _strip_protocol(cls, path):
            path = super()._strip_protocol(path)
            # seaweedfs://host:port/a/b: the netloc is connection info
            # (_get_kwargs_from_urls), the path is /a/b
            if "/" in path and ":" in path.split("/", 1)[0]:
                path = "/" + path.split("/", 1)[1]
            elif ":" in path.split("/", 1)[0]:
                path = "/"
            if not path.startswith("/"):
                path = "/" + path
            return path.rstrip("/") or "/"

        @staticmethod
        def _get_kwargs_from_urls(path):
            parts = urlsplit(path)
            return {"filer": parts.netloc} if parts.netloc else {}

        # -- metadata --------------------------------------------------------
        def info(self, path, **kwargs):
            path = self._strip_protocol(path)
            if path == "/":
                return {"name": "/", "size": 0, "type": "directory", "mtime": 0}
            d = self.client.get_entry(path)
            if d is None:
                raise FileNotFoundError(path)
            return _entry_info(d, path)

        def ls(self, path, detail=False, **kwargs):
            path = self._strip_protocol(path)
            info = self.info(path)
            if info["type"] != "directory":
                return [info] if detail else [info["name"]]
            out, cursor = [], ""
            while True:
                page = self.client.list(path, start_after=cursor, limit=1000)
                if not page:
                    break
                for d in page:
                    name = d.get("name") or d.get("full_path", "").rsplit("/", 1)[-1]
                    child = (path.rstrip("/") + "/" + name) if path != "/" else "/" + name
                    out.append(_entry_info(d, child))
                    cursor = name
                if len(page) < 1000:
                    break
            return out if detail else [o["name"] for o in out]

        def exists(self, path, **kwargs):
            try:
                self.info(path)
                return True
            except FileNotFoundError:
                return False

        # -- directory ops ---------------------------------------------------
        def mkdir(self, path, create_parents=True, **kwargs):
            path = self._strip_protocol(path)
            if path != "/":
                self.client.mkdir(path)

        def makedirs(self, path, exist_ok=False):
            path = self._strip_protocol(path)
            if not exist_ok and self.exists(path):
                raise FileExistsError(path)
            self.mkdir(path)  # the filer makes the parents

        def rmdir(self, path):
            path = self._strip_protocol(path)
            st = self.client.delete(path)
            if st == 404:
                raise FileNotFoundError(path)
            if st >= 400:
                raise OSError(f"rmdir {path}: HTTP {st}")

        def _rm(self, path):
            path = self._strip_protocol(path)
            if self.client.delete(path) == 404:
                raise FileNotFoundError(path)

        def rm(self, path, recursive=False, maxdepth=None):
            path = self._strip_protocol(path)
            st = self.client.delete(path, recursive=recursive)
            if st == 404:
                raise FileNotFoundError(path)
            if st >= 400:
                raise OSError(f"rm {path}: HTTP {st}")

        def mv(self, path1, path2, **kwargs):
            path1, path2 = self._strip_protocol(path1), self._strip_protocol(path2)
            if not self.exists(path1):
                raise FileNotFoundError(path1)
            self.client.rename(path1, path2)

        def cp_file(self, path1, path2, **kwargs):
            # no server-side copy (nor in the reference): stream through
            # chunk-size pieces
            with self.open(path1, "rb") as src, self.open(path2, "wb") as dst:
                while block := src.read(self.chunk_size):
                    dst.write(block)

        def created(self, path):
            d = self.client.get_entry(self._strip_protocol(path))
            if d is None:
                raise FileNotFoundError(path)
            return d.get("crtime", 0)

        def modified(self, path):
            return self.info(path)["mtime"]

        # -- file IO ---------------------------------------------------------
        def _open(self, path, mode="rb", block_size=None, autocommit=True,
                  cache_options=None, **kwargs):
            return SeaweedFile(self, self._strip_protocol(path), mode,
                               block_size=block_size or self.chunk_size,
                               autocommit=autocommit, cache_options=cache_options,
                               **kwargs)

        def cat_file(self, path, start=None, end=None, **kwargs):
            path = self._strip_protocol(path)
            rng = None
            if start is not None or end is not None:
                info = self.info(path)
                s = start or 0
                if s < 0:
                    s += info["size"]
                e = info["size"] if end is None else (end if end >= 0 else end + info["size"])
                if e <= s:
                    return b""
                rng = f"bytes={s}-{e - 1}"
            status, body, _ = self.client.get_object(path, rng=rng)
            if status == 404:
                raise FileNotFoundError(path)
            if status >= 400 and status != 416:
                raise OSError(f"read {path}: HTTP {status}")
            return b"" if status == 416 else body

        def pipe_file(self, path, value, **kwargs):
            with self.open(path, "wb") as f:
                f.write(value)

        def chunk_writer(self) -> ChunkWriter:
            if self._writer is None:
                self._writer = ChunkWriter(self.client, self.chunk_size, self.collection,
                                           self.ttl, self.cipher)
            return self._writer

    class SeaweedFile(AbstractBufferedFile):
        """Ranged reads; writes stream chunk-size pieces straight to the
        volume servers and commit the entry on close."""

        def __init__(self, fs, path: str, mode: str = "rb", **kwargs):
            self._chunks: list = []
            self._append_base = 0
            super().__init__(fs, path, mode, **kwargs)

        def _fetch_range(self, start: int, end: int) -> bytes:
            if end <= start:
                return b""
            status, body, _ = self.fs.client.get_object(self.path, rng=f"bytes={start}-{end - 1}")
            if status == 404:
                raise FileNotFoundError(self.path)
            if status == 416:
                return b""
            if status >= 400:
                raise OSError(f"read {self.path}: HTTP {status}")
            return body

        def _initiate_upload(self):
            self._chunks = []
            self._append_base = 0
            if "a" in self.mode:
                # append: keep the chunk list; new chunks land after it
                d = self.fs.client.get_entry(self.path)
                if d is not None:
                    e = Entry.from_dict(d)
                    self._chunks = list(e.chunks)
                    self._append_base = e.file_size()

        def _upload_chunk(self, final=False) -> bool:
            data = self.buffer.getvalue()
            if data:
                base = self._append_base + (self.offset or 0)
                self._chunks.extend(self.fs.chunk_writer().save_data_as_chunks(data, base))
            if final:
                entry = Entry(full_path=self.path, is_directory=False, mtime=int(time.time()),
                              mime="application/octet-stream", collection=self.fs.collection,
                              chunks=list(self._chunks))
                self.fs.client.create_entry(self.path, entry.to_dict())
            return True

    # pickle finds the classes through this module's __getattr__
    for cls in (SeaweedFileSystem, SeaweedFile):
        cls.__module__ = __name__
        cls.__qualname__ = cls.__name__
    return {"SeaweedFileSystem": SeaweedFileSystem, "SeaweedFile": SeaweedFile}


_classes: Optional[dict] = None


def __getattr__(name: str):
    global _classes
    if name in ("SeaweedFileSystem", "SeaweedFile"):
        if _classes is None:
            _classes = _build_classes()
        return _classes[name]
    raise AttributeError(name)


def register() -> None:
    """Register the ``seaweedfs`` and ``swfs`` protocols with fsspec."""
    import fsspec

    cls = __getattr__("SeaweedFileSystem")
    fsspec.register_implementation("seaweedfs", cls, clobber=True)
    fsspec.register_implementation("swfs", cls, clobber=True)
