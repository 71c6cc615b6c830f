"""Backend storage files: the IO abstraction under a volume's .dat.

Mirrors `weed/storage/backend/backend.go:15-25` (BackendStorageFile):
read_at/write_at/truncate/close/size/name/sync. ``DiskFile`` wraps a local
file (backend/disk_file.go). The remote S3 tier is not ported.
"""

from __future__ import annotations

import os
import threading


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
        self._lock = threading.Lock()

    def read_at(self, offset: int, size: int) -> bytes:
        # raw FileIO reads are single syscalls and may be partial
        with self._lock:
            self._f.seek(offset)
            chunks = []
            remaining = size
            while remaining > 0:
                b = self._f.read(remaining)
                if not b:
                    break  # EOF
                chunks.append(b)
                remaining -= len(b)
            return b"".join(chunks)

    def write_at(self, offset: int, data: bytes) -> int:
        with self._lock:
            self._f.seek(offset)
            view = memoryview(data)
            written = 0
            while written < len(data):
                n = self._f.write(view[written:])
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
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()
