"""Plain Haystack volume writer: the .dat a SeaweedFS volume holds after a
run of needle POSTs, worked out again from the needles' bytes.

Version 3 layout (``needle_read_write.go:33-128``): a record is cookie u32,
id u64, size u32 (big endian); then data_size u32, data, flags u8 and, for
a POST, last_modified as 5 bytes; then the masked CRC-32C of the data, the
append time in ns as u64, and 1..8 bytes of padding to an 8-byte boundary,
which repeat the size's 4 bytes and then zeros. The volume starts with an
8-byte super block: version, replica placement, ttl, compaction revision,
extra size.

No clock is fixed by a seed, so the two time fields of each record
(``last_modified`` and ``append_at_ns``) are the only bytes this module
takes from the volume it judges; ``time_fields`` says where they lie.

CRC-32C (Castagnoli) is computed in NumPy over all needles at once: each
payload is cut into 1 KiB chunks (zeros in front do not change a CRC that
starts from 0), the chunks' CRCs are taken in lockstep, and each needle's
are joined by the linear "append n zero bytes" operator.
"""

from __future__ import annotations

import struct

import numpy as np

VERSION3 = 3
FLAG_HAS_LAST_MODIFIED = 0x08
HEADER, CHECKSUM, TIMESTAMP, LAST_MODIFIED = 16, 4, 8, 5
SUPER_BLOCK = 8

_POLY = 0x82F63B78  # CRC-32C, reflected
_CHUNK = 1024


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_T = _byte_table()


def _apply(op: np.ndarray, x: np.ndarray) -> np.ndarray:
    """A linear map of CRC states, given as 4 tables of 256 (one per byte)."""
    x = x.astype(np.uint32)
    return (op[0][x & 0xFF] ^ op[1][(x >> 8) & 0xFF] ^ op[2][(x >> 16) & 0xFF]
            ^ op[3][x >> 24])


def _zeros_op(nbytes_log2: int) -> np.ndarray:
    """The map "feed 2**nbytes_log2 zero bytes" on a raw CRC state."""
    basis = (np.arange(256, dtype=np.uint32)[None, :] << (8 * np.arange(4, dtype=np.uint32)[:, None]))
    op = (_T[basis & 0xFF] ^ (basis >> 8)).astype(np.uint32)  # one zero byte
    for _ in range(nbytes_log2):
        op = np.stack([_apply(op, op[j]) for j in range(4)])
    return op


_ZOPS = [_zeros_op(i) for i in range(31)]
_ZCHUNK = _ZOPS[_CHUNK.bit_length() - 1]


def crc32c(payloads: list) -> np.ndarray:
    """CRC-32C of each byte string in ``payloads`` (uint32 array)."""
    lens = np.array([len(p) for p in payloads], dtype=np.int64)
    nchunks = -(-lens // _CHUNK)
    starts = np.concatenate([[0], np.cumsum(nchunks)[:-1]])
    flat = np.zeros(int(nchunks.sum()) * _CHUNK, dtype=np.uint8)
    for p, s, n, ln in zip(payloads, starts, nchunks, lens):
        end = (int(s) + int(n)) * _CHUNK
        flat[end - int(ln):end] = np.frombuffer(p, dtype=np.uint8)
    cols = np.ascontiguousarray(flat.reshape(-1, _CHUNK).T)
    state = np.zeros(cols.shape[1], dtype=np.uint32)
    for row in cols:
        state = _T[(state ^ row) & 0xFF] ^ (state >> 8)
    acc = np.zeros(len(payloads), dtype=np.uint32)
    for j in range(int(nchunks.max(initial=0))):
        live = nchunks > j
        acc[live] = _apply(_ZCHUNK, acc[live]) ^ state[starts[live] + j]
    init = np.full(len(payloads), 0xFFFFFFFF, dtype=np.uint32)
    for i, op in enumerate(_ZOPS):
        bit = ((lens >> i) & 1).astype(bool)
        if bit.any():
            init[bit] = _apply(op, init[bit])
    return init ^ acc ^ np.uint32(0xFFFFFFFF)


def masked(crc: int) -> int:
    """The value SeaweedFS stores (``crc.go:24``)."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def record_size(data_len: int) -> int:
    """The record's ``size`` field for a POSTed payload."""
    return 4 + data_len + 1 + LAST_MODIFIED


def record_length(data_len: int) -> int:
    """Bytes the record takes in the .dat, padding included."""
    used = HEADER + record_size(data_len) + CHECKSUM + TIMESTAMP
    return used + 8 - used % 8


def super_block(replication: str = "000") -> bytes:
    rp = int(replication[0]) * 100 + int(replication[1]) * 10 + int(replication[2])
    return bytes([VERSION3, rp, 0, 0, 0, 0, 0, 0])


def time_fields(data_lens: list) -> list:
    """(offset of last_modified, offset of append_at_ns) in the .dat of each
    record, in order."""
    out, pos = [], SUPER_BLOCK
    for n in data_lens:
        lm = pos + HEADER + 4 + n + 1
        out.append((lm, lm + LAST_MODIFIED + CHECKSUM))
        pos += record_length(n)
    return out


def volume(needles: list, times: list, replication: str = "000") -> bytes:
    """The .dat of a volume that took ``needles`` [(cookie, key, payload)]
    in order, each POSTed with (last_modified, append_at_ns) ``times``."""
    crcs = crc32c([p for _, _, p in needles])
    parts = [super_block(replication)]
    for (cookie, key, payload), (lm, at_ns), crc in zip(needles, times, crcs):
        size = record_size(len(payload))
        used = HEADER + size + CHECKSUM + TIMESTAMP
        parts += [struct.pack(">IQII", cookie, key, size, len(payload)), payload,
                  bytes([FLAG_HAS_LAST_MODIFIED]), struct.pack(">Q", lm)[3:],
                  struct.pack(">IQ", masked(int(crc)), at_ns),
                  (struct.pack(">I", size) + b"\0" * 4)[:8 - used % 8]]
    return b"".join(parts)
