"""Needle: the on-disk record of one stored file.

Byte-compatible with the reference's v1/v2/v3 layouts
(`weed/storage/needle/needle.go:24`, `needle_read_write.go:33-128`):

    header (16B):  cookie u32BE | id u64BE | size u32BE
    v2/v3 body (size bytes, only if data present):
        data_size u32BE | data | flags u8
        [name_size u8 | name]           if FLAG_HAS_NAME
        [mime_size u8 | mime]           if FLAG_HAS_MIME
        [last_modified 5B BE]           if FLAG_HAS_LAST_MODIFIED
        [ttl 2B]                        if FLAG_HAS_TTL
        [pairs_size u16BE | pairs]      if FLAG_HAS_PAIRS
    checksum u32BE (masked CRC-32C of data, crc.go:24)
    v3 only: append_at_ns u64BE
    padding to the next 8-byte boundary — ALWAYS 1..8 bytes
      (PaddingLength returns 8, not 0, when already aligned —
       needle_read_write.go:298-304)

Padding-byte contents replicate a quirk of the reference: the writer reuses
its header scratch buffer, so v1/v2 padding bytes are a prefix of the
big-endian needle id, and v3 padding bytes are the big-endian size followed
by zeros (needle_read_write.go:114-122 — the appended slice
``header[NeedleChecksumSize(+TimestampSize):...+padding]`` aliases those
previously-written fields). We reproduce this so .dat files are bit-identical.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import crc as crc32c
from .ttl import TTL, EMPTY_TTL, load_ttl_from_bytes
from .types import (
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_PADDING_SIZE,
    TIMESTAMP_SIZE,
    bytes_to_cookie,
    bytes_to_needle_id,
    bytes_to_size,
    cookie_to_bytes,
    needle_id_to_bytes,
    size_to_bytes,
)

# flags (needle_read_write.go:15-25)
FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2

VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3


class SizeMismatchError(Exception):
    pass


class CrcError(Exception):
    pass


def padding_length(needle_size: int, version: int) -> int:
    """Bytes of padding after the record — always in 1..8 (never 0)."""
    if version == VERSION3:
        used = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE
    else:
        used = NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE
    return NEEDLE_PADDING_SIZE - (used % NEEDLE_PADDING_SIZE)


def needle_body_length(needle_size: int, version: int) -> int:
    extra = TIMESTAMP_SIZE if version == VERSION3 else 0
    return needle_size + NEEDLE_CHECKSUM_SIZE + extra + padding_length(needle_size, version)


def get_actual_size(needle_size: int, version: int) -> int:
    return NEEDLE_HEADER_SIZE + needle_body_length(needle_size, version)


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0  # sum of data_size,data,name_size,name,mime_size,mime,...
    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0  # unix seconds; only low 5 bytes stored
    ttl: TTL = field(default_factory=lambda: EMPTY_TTL)
    checksum: int = 0  # raw (unmasked) CRC-32C of data
    append_at_ns: int = 0  # v3

    # -- flag helpers --------------------------------------------------------
    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set_flag(self, flag: int) -> None:
        # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
        self.flags |= flag

    @property
    def is_compressed(self) -> bool:
        return self.has(FLAG_IS_COMPRESSED)

    @property
    def is_chunk_manifest(self) -> bool:
        return self.has(FLAG_IS_CHUNK_MANIFEST)

    def etag(self) -> str:
        return struct.pack(">I", self.checksum & 0xFFFFFFFF).hex()

    # -- size computation (needle_read_write.go:62-81) -----------------------
    def _computed_size(self) -> int:
        if len(self.data) == 0:
            return 0
        size = 4 + len(self.data) + 1
        if self.has(FLAG_HAS_NAME):
            size += 1 + min(len(self.name), 0xFF)
        if self.has(FLAG_HAS_MIME):
            size += 1 + len(self.mime)
        if self.has(FLAG_HAS_LAST_MODIFIED):
            size += LAST_MODIFIED_BYTES_LENGTH
        if self.has(FLAG_HAS_TTL):
            size += TTL_BYTES_LENGTH
        if self.has(FLAG_HAS_PAIRS):
            size += 2 + len(self.pairs)
        return size

    # -- serialization -------------------------------------------------------
    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """The full on-disk record (prepareWriteBuffer, needle_read_write.go:33)."""
        self.checksum = crc32c.new(self.data)
        if version == VERSION1:
            # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
            self.size = len(self.data)
            out = bytearray()
            out += cookie_to_bytes(self.cookie)
            out += needle_id_to_bytes(self.id)
            out += size_to_bytes(self.size)
            out += self.data
            out += struct.pack(">I", crc32c.masked_value(self.checksum))
            pad = padding_length(self.size, version)
            # quirk: v1 padding aliases the header's id bytes
            out += needle_id_to_bytes(self.id)[:pad]
            return bytes(out)
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")

        self.size = self._computed_size()
        out = bytearray()
        out += cookie_to_bytes(self.cookie)
        out += needle_id_to_bytes(self.id)
        out += size_to_bytes(self.size)
        if len(self.data) > 0:
            out += struct.pack(">I", len(self.data))
            out += self.data
            out += bytes([self.flags & 0xFF])
            if self.has(FLAG_HAS_NAME):
                name = self.name[:0xFF]
                out += bytes([len(name)])
                out += name
            if self.has(FLAG_HAS_MIME):
                out += bytes([len(self.mime) & 0xFF])
                out += self.mime
            if self.has(FLAG_HAS_LAST_MODIFIED):
                out += struct.pack(">Q", self.last_modified)[8 - LAST_MODIFIED_BYTES_LENGTH :]
            if self.has(FLAG_HAS_TTL):
                out += self.ttl.to_bytes()
            if self.has(FLAG_HAS_PAIRS):
                out += struct.pack(">H", len(self.pairs))
                out += self.pairs
        pad = padding_length(self.size, version)
        out += struct.pack(">I", crc32c.masked_value(self.checksum))
        if version == VERSION2:
            # quirk: v2 padding aliases the header's id bytes
            out += needle_id_to_bytes(self.id)[:pad]
        else:
            out += struct.pack(">Q", self.append_at_ns)
            # quirk: v3 padding aliases the header's size bytes, then zeros
            pad_src = size_to_bytes(self.size) + b"\x00" * 4
            out += pad_src[:pad]
        return bytes(out)

    # -- deserialization -----------------------------------------------------
    def parse_header(self, b: bytes) -> None:
        # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
        self.cookie = bytes_to_cookie(b[0:4])
        # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
        self.id = bytes_to_needle_id(b[4:12])
        self.size = bytes_to_size(b[12:16])

    def _read_body_v2(self, b: bytes) -> None:
        """Parse the v2/v3 body fields (readNeedleDataVersion2, :219-278)."""
        idx = 0
        n = len(b)
        if idx < n:
            data_size = struct.unpack(">I", b[idx : idx + 4])[0]
            idx += 4
            if data_size + idx >= n:
                # the flags byte always follows the data — a data_size that
                # leaves no room for it is a corrupt length prefix
                raise ValueError("needle body truncated: data")
            self.data = bytes(b[idx : idx + data_size])
            idx += data_size
            self.flags = b[idx]
            idx += 1
        if idx < n and self.has(FLAG_HAS_NAME):
            name_size = b[idx]
            idx += 1
            if name_size + idx > n:
                raise ValueError("needle body truncated: name")
            self.name = bytes(b[idx : idx + name_size])
            idx += name_size
        if idx < n and self.has(FLAG_HAS_MIME):
            mime_size = b[idx]
            idx += 1
            if mime_size + idx > n:
                raise ValueError("needle body truncated: mime")
            self.mime = bytes(b[idx : idx + mime_size])
            idx += mime_size
        if idx < n and self.has(FLAG_HAS_LAST_MODIFIED):
            if LAST_MODIFIED_BYTES_LENGTH + idx > n:
                raise ValueError("needle body truncated: last_modified")
            self.last_modified = int.from_bytes(
                b[idx : idx + LAST_MODIFIED_BYTES_LENGTH], "big"
            )
            idx += LAST_MODIFIED_BYTES_LENGTH
        if idx < n and self.has(FLAG_HAS_TTL):
            if TTL_BYTES_LENGTH + idx > n:
                raise ValueError("needle body truncated: ttl")
            self.ttl = load_ttl_from_bytes(b[idx : idx + TTL_BYTES_LENGTH])
            idx += TTL_BYTES_LENGTH
        if idx < n and self.has(FLAG_HAS_PAIRS):
            if 2 + idx > n:
                raise ValueError("needle body truncated: pairs size")
            pairs_size = struct.unpack(">H", b[idx : idx + 2])[0]
            idx += 2
            if pairs_size + idx > n:
                raise ValueError("needle body truncated: pairs")
            # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
            self.pairs = bytes(b[idx : idx + pairs_size])
            idx += pairs_size

    @classmethod
    def from_bytes(
        cls, b: bytes, size: int, version: int = CURRENT_VERSION, verify_crc: bool = True
    ) -> "Needle":
        """Hydrate from a full record blob (ReadBytes, needle_read_write.go:170)."""
        n = cls()
        n.parse_header(b)
        if n.size != size:
            raise SizeMismatchError(f"found size {n.size}, expected {size}")
        if version == VERSION1:
            n.data = bytes(b[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + size])
        else:
            n._read_body_v2(b[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + size])
        if size > 0 and verify_crc:
            stored = struct.unpack(
                ">I",
                b[NEEDLE_HEADER_SIZE + size : NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE],
            )[0]
            actual = crc32c.new(n.data)
            if stored != crc32c.masked_value(actual):
                raise CrcError("CRC error! data on disk corrupted")
            n.checksum = actual
        if version == VERSION3:
            ts_off = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
            n.append_at_ns = struct.unpack(">Q", b[ts_off : ts_off + TIMESTAMP_SIZE])[0]
        return n

    def read_body_bytes(self, body: bytes, version: int) -> None:
        """Parse a body read separately from the header (ReadNeedleBodyBytes, :330)."""
        if not body:
            return
        if version == VERSION1:
            self.data = bytes(body[: self.size])
        else:
            self._read_body_v2(body[: self.size])
            if version == VERSION3:
                ts_off = self.size + NEEDLE_CHECKSUM_SIZE
                self.append_at_ns = struct.unpack(
                    ">Q", body[ts_off : ts_off + TIMESTAMP_SIZE]
                )[0]
        self.checksum = crc32c.new(self.data)


def parse_needle_header(b: bytes) -> tuple[int, int, int]:
    """(cookie, id, size) from a 16-byte header."""
    return bytes_to_cookie(b[0:4]), bytes_to_needle_id(b[4:12]), bytes_to_size(b[12:16])
