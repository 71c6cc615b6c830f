"""Backend storage files: the IO abstraction under a volume's .dat.

Mirrors `weed/storage/backend/backend.go:15-25` (BackendStorageFile):
read_at/write_at/truncate/close/size/name/sync. ``DiskFile`` wraps a local
file (backend/disk_file.go). The remote S3 tier lives beside it
(``s3_backend.py``, backend/s3_backend/s3_backend.go).
"""

from __future__ import annotations

import os
from ...util.locks import make_lock


class BackendStorageFile:
    def read_at(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def write_at(self, offset: int, data: bytes) -> int:
        raise NotImplementedError

    def append(self, data: bytes) -> int:
        """Write at the current end; returns the offset written at."""
        end = self.size()
        self.write_at(end, data)
        return end

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


class DiskFile(BackendStorageFile):
    """Local file with positional IO (backend/disk_file.go)."""

    def __init__(self, path: str, create: bool = False):
        self._path = path
        mode = "r+b" if os.path.exists(path) else ("w+b" if create else None)
        if mode is None:
            raise FileNotFoundError(path)
        # unbuffered: every write() reaches the kernel before the ack, as
        # with Go's os.File, so a kill -9 loses no acknowledged needle
        self._f = open(path, mode, buffering=0)
        self._lock = make_lock("DiskFile._lock")

    # Positional IO (pread/pwrite) never moves the file offset, which the fd
    # shares with its dups: a zero-copy reply sendfiles from a dup of this fd,
    # and socket.sendfile / loop.sendfile seek that dup when they finish. A
    # seek-then-read here could read at the position such a seek left behind.
    def read_at(self, offset: int, size: int) -> bytes:
        # a pread may return fewer bytes than asked
        with self._lock:
            fd = self._f.fileno()
            chunks = []
            remaining = size
            while remaining > 0:
                b = os.pread(fd, remaining, offset + size - remaining)
                if not b:
                    break  # EOF
                chunks.append(b)
                remaining -= len(b)
            return b"".join(chunks)

    def write_at(self, offset: int, data: bytes) -> int:
        with self._lock:
            fd = self._f.fileno()
            view = memoryview(data)
            written = 0
            while written < len(data):
                n = os.pwrite(fd, view[written:], offset + written)
                if not n:
                    raise OSError(f"short write at {offset + written} in {self._path}")
                written += n
            return written

    def truncate(self, size: int) -> None:
        with self._lock:
            self._f.truncate(size)

    def size(self) -> int:
        with self._lock:
            return os.fstat(self._f.fileno()).st_size

    def name(self) -> str:
        return self._path

    def fileno(self) -> int:
        return self._f.fileno()

    def sync(self) -> None:
        with self._lock:
            # sweedlint: ok blocking-under-lock per-fd leaf lock serializing write+fsync; nothing nests inside it
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class MemoryFile(BackendStorageFile):
    """In-memory backend (tests; analog of backend/memory_map)."""

    def __init__(self, name: str = "<memory>"):
        self._buf = bytearray()
        self._name = name
        self._lock = make_lock("MemoryFile._lock")

    def read_at(self, offset: int, size: int) -> bytes:
        with self._lock:
            return bytes(self._buf[offset : offset + size])

    def write_at(self, offset: int, data: bytes) -> int:
        with self._lock:
            end = offset + len(data)
            if end > len(self._buf):
                self._buf.extend(b"\x00" * (end - len(self._buf)))
            self._buf[offset:end] = data
            return len(data)

    def truncate(self, size: int) -> None:
        with self._lock:
            del self._buf[size:]

    def size(self) -> int:
        with self._lock:
            return len(self._buf)

    def name(self) -> str:
        return self._name
