"""CRC-32C (Castagnoli) needle checksums, with the reference's masked value.

The reference checksums needle data with CRC-32C (`weed/storage/needle/crc.go`,
klauspost/crc32 Castagnoli table) and stores a *masked* value on disk:

    Value() = rotr32(crc, 15) + 0xa282ead8        (crc.go:24-26)

(the snappy/leveldb CRC mask). Both the raw crc and the masked value are
exposed here.

Two versions compute the same function:

- ``native``: slicing-by-8 in C++ (``csrc/crc32c.cpp``), compiled with the
  system ``g++`` at first use into the git-ignored ``csrc/build/`` and bound
  with ctypes (the call releases the interpreter lock);
- ``table``: the same slicing-by-8 in pure Python (``table_update``), a few
  MB/s. It is the plain version the tests hold the native one to, and what
  runs where no C++ compiler is installed.

``implementation()`` says which one ``update`` runs; nothing is built at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading

import numpy as np

CASTAGNOLI_POLY_REFLECTED = 0x82F63B78
_MASK_DELTA = 0xA282EAD8

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "crc32c.cpp")
BUILD_DIR = os.path.join(_CSRC, "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# 8 tables for slicing-by-8 (table[0] is the classic byte-at-a-time table).
_TABLES: list[list[int]] = []


def _build_tables() -> None:
    t0 = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (CASTAGNOLI_POLY_REFLECTED if crc & 1 else 0)
        t0.append(crc)
    _TABLES.append(t0)
    for k in range(1, 8):
        prev = _TABLES[k - 1]
        _TABLES.append([(prev[i] >> 8) ^ t0[prev[i] & 0xFF] for i in range(256)])


_build_tables()


def table_update(crc: int, data) -> int:
    """Incremental CRC-32C in pure Python (the plain version)."""
    crc ^= 0xFFFFFFFF
    t = _TABLES
    mv = memoryview(data).cast("B")
    n = len(mv)
    i = 0
    # slicing-by-8
    while n - i >= 8:
        crc ^= int.from_bytes(mv[i : i + 4], "little")
        crc = (
            t[7][crc & 0xFF]
            ^ t[6][(crc >> 8) & 0xFF]
            ^ t[5][(crc >> 16) & 0xFF]
            ^ t[4][(crc >> 24) & 0xFF]
            ^ t[3][mv[i + 4]]
            ^ t[2][mv[i + 5]]
            ^ t[1][mv[i + 6]]
            ^ t[0][mv[i + 7]]
        )
        i += 8
    while i < n:
        crc = (crc >> 8) ^ t[0][(crc ^ mv[i]) & 0xFF]
        i += 1
    return crc ^ 0xFFFFFFFF


def build() -> str:
    """Compile ``crc32c.cpp`` into ``csrc/build/`` unless a library built
    from the same source and flags is already there. Returns its path;
    raises if there is no ``g++`` or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++): cannot build crc32c.cpp")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libcrc32c-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    # sweedlint: ok durability build artifact under csrc/build, not volume data; tmp+rename makes a concurrent build atomic
    os.replace(tmp, lib_path)  # atomic: a concurrent builder sees all or nothing
    return lib_path


_lock = threading.Lock()
_native = None  # the bound C function once loaded
_impl: "str | None" = None  # "native" or "table", decided at first use


def _select() -> str:
    global _native, _impl
    with _lock:
        if _impl is None:
            try:
                fn = ctypes.CDLL(build()).crc32c_update
            except (OSError, RuntimeError) as e:
                logging.getLogger(__name__).warning(
                    "native CRC-32C unavailable, using the table version: %s", e)
                _impl = "table"
            else:
                fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
                fn.restype = ctypes.c_uint32
                _native = fn
                _impl = "native"
    return _impl


def implementation() -> str:
    """``"native"`` or ``"table"``: the version ``update`` runs (builds the
    native library on first call)."""
    return _impl or _select()


def _call_native(crc: int, data) -> int:
    buf = np.frombuffer(data, dtype=np.uint8)  # no copy; kept alive for the call
    return _native(crc & 0xFFFFFFFF, buf.ctypes.data if len(buf) else None, len(buf))


def native_update(crc: int, data) -> int:
    """Incremental CRC-32C through the C++ library; raises if it cannot be
    built. ``data`` is any contiguous buffer (bytes, bytearray, memoryview,
    uint8 ndarray)."""
    if (_impl or _select()) != "native":
        raise RuntimeError("native CRC-32C library unavailable")
    return _call_native(crc, data)


def update(crc: int, data) -> int:
    """Incremental CRC-32C, matching Go's ``crc32.Update`` semantics."""
    if (_impl or _select()) == "native":
        return _call_native(crc, data)
    return table_update(crc, data)


def new(data: bytes = b"") -> int:
    """CRC-32C of ``data`` from a zero seed (crc.go:16-18)."""
    return update(0, data)


def masked_value(crc: int) -> int:
    """The value actually stored on disk (crc.go:24-26)."""
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + _MASK_DELTA) & 0xFFFFFFFF
