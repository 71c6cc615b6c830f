"""Backend storage: local and remote IO under a volume's .dat, laid out as
the reference's `weed/storage/backend/`:

    core.py        BackendStorageFile, DiskFile, MemoryFile
    s3_backend.py  S3BackendStorage, RemoteS3File (the cold tier)
    fake_s3.py     a directory-backed S3 stand-in for tests and the GPU check
"""

from .core import BackendStorageFile, DiskFile, MemoryFile
from .s3_backend import RemoteS3File, S3BackendStorage

__all__ = [
    "BackendStorageFile",
    "DiskFile",
    "MemoryFile",
    "RemoteS3File",
    "S3BackendStorage",
]
