"""File IDs: ``<volumeId>,<needleKeyHex><cookieHex8>`` e.g. ``3,01637037d6``.

Matches `weed/storage/needle/file_id.go` and `needle.go:120-165`
(ParsePath / ParseNeedleIdCookie / formatNeedleIdCookie): the hex blob is the
8-byte big-endian needle id with leading zero *bytes* stripped, followed by
the 4-byte cookie (always 8 hex chars).
"""

from __future__ import annotations

from dataclasses import dataclass

from .types import (
    COOKIE_SIZE,
    NEEDLE_ID_SIZE,
    cookie_to_bytes,
    needle_id_to_bytes,
    parse_cookie,
    parse_needle_id,
)


def format_needle_id_cookie(key: int, cookie: int) -> str:
    b = needle_id_to_bytes(key) + cookie_to_bytes(cookie)
    nz = 0
    while nz < NEEDLE_ID_SIZE and b[nz] == 0:
        nz += 1
    return b[nz:].hex()


def parse_needle_id_cookie(key_hash: str) -> tuple[int, int]:
    if len(key_hash) <= COOKIE_SIZE * 2:
        raise ValueError(f"key hash {key_hash!r} too short")
    if len(key_hash) > (NEEDLE_ID_SIZE + COOKIE_SIZE) * 2:
        raise ValueError(f"key hash {key_hash!r} too long")
    split = len(key_hash) - COOKIE_SIZE * 2
    return parse_needle_id(key_hash[:split]), parse_cookie(key_hash[split:])


def parse_path(fid: str) -> tuple[int, int]:
    """fid path segment → (needle id, cookie); supports the ``_<delta>``
    suffix of batch assigns (needle.go:120-142)."""
    if len(fid) <= COOKIE_SIZE * 2:
        raise ValueError(f"invalid fid {fid!r}")
    delta = 0
    if "_" in fid:
        fid, delta_str = fid.rsplit("_", 1)
        delta = int(delta_str)
    nid, cookie = parse_needle_id_cookie(fid)
    return nid + delta, cookie


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"wrong fid format {fid!r}")
        key, cookie = parse_path(fid[comma + 1 :])
        return cls(int(fid[:comma]), key, cookie)
