"""Plain RS(10,4) over GF(2^8), as klauspost/reedsolomon computes it.

A frozen copy: the field's exponent table (x^8+x^4+x^3+x^2+1, generator 2)
and the four parity rows of klauspost's default (inverted Vandermonde)
matrix for 10 data and 4 parity shards are literals here, and the tests
hold them against their definitions. NumPy only: this is the yardstick the
port's shards are judged by, so it shares no code with the port.

SeaweedFS's layout (``ec_encoder.go:194-231``): the .dat is striped row by
row into 10 data shards, in rows of 10 x 1 GiB while more than one such
row remains, then rows of 10 x 1 MiB zero-padded past the end.
"""

from __future__ import annotations

import numpy as np

DATA_SHARDS, PARITY_SHARDS, TOTAL_SHARDS = 10, 4, 14
LARGE_BLOCK, SMALL_BLOCK = 1 << 30, 1 << 20
POLYNOMIAL = 0x11D

EXP = np.frombuffer(bytes.fromhex(
    "01020408102040801d3a74e8cd8713264c982d5ab475eac98f03060c183060c09d274e9c254a94"
    "356ad4b577eec19f23468c050a142850a05dba69d2b96fdea15fbe61c2992f5ebc65ca890f1e3c"
    "78f0fde7d3bb6bd6b17ffee1dfa35bb671e2d9af4386112244880d1a3468d0bd67ce811f3e7cf8"
    "edc7933b76ecc5973366cc85172e5cb86ddaa94f9e214284152a54a84d9a2952a455aa49923972"
    "e4d5b773e6d1bf63c6913f7efce5d7b37bf6f1ffe3dbab4b963162c495376edca557ae41821932"
    "64c88d070e1c3870e0dda753a651a259b279f2f9efc39b2b56ac458a09122448903d7af4f5f7f3"
    "fbebcb8b0b162c58b07dfae9cf831b366cd8ad478e"), dtype=np.uint8)  # alpha**i, i < 255

PARITY_ROWS = np.array([
    [129, 150, 175, 184, 210, 196, 254, 232, 3, 2],
    [150, 129, 184, 175, 196, 210, 232, 254, 2, 3],
    [191, 214, 98, 10, 6, 111, 223, 183, 5, 4],
    [214, 191, 10, 98, 111, 6, 183, 223, 4, 5],
], dtype=np.uint8)

LOG = np.zeros(256, dtype=np.int64)
LOG[EXP] = np.arange(255)


def _mul_table() -> np.ndarray:
    """MUL[a, b] = a * b in the field."""
    a = np.arange(256)[:, None]
    b = np.arange(256)[None, :]
    out = EXP[(LOG[a] + LOG[b]) % 255]
    out[(a == 0) | (b == 0)] = 0
    return out.astype(np.uint8)


MUL = _mul_table()
INV = np.array([0] + [int(EXP[(255 - LOG[x]) % 255]) for x in range(1, 256)], dtype=np.uint8)


def generator() -> np.ndarray:
    """The 14 x 10 systematic generator: identity over the parity rows."""
    return np.concatenate([np.eye(DATA_SHARDS, dtype=np.uint8), PARITY_ROWS])


def matmul(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[r] = XOR over d of matrix[r, d] * data[d]: (R, k) by (k, n) bytes."""
    out = np.zeros((matrix.shape[0], data.shape[1]), dtype=np.uint8)
    for r in range(matrix.shape[0]):
        for d in range(matrix.shape[1]):
            c = int(matrix[r, d])
            if c == 1:
                out[r] ^= data[d]
            elif c:
                out[r] ^= MUL[c][data[d]]
    return out


def matmul_xor(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The control's arithmetic: every nonzero coefficient taken as 1, so a
    parity row is the XOR of its data rows (RAID-5's code, which survives
    one lost shard where RS(10,4) survives four)."""
    return matmul((np.asarray(matrix) != 0).astype(np.uint8), data)


def invert(m: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix over the field (Gauss-Jordan)."""
    n = m.shape[0]
    a = np.concatenate([m.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        a[[col, piv]] = a[[piv, col]]
        a[col] = MUL[INV[a[col, col]]][a[col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= MUL[a[r, col]][a[col]]
    return a[:, n:]


def reconstruct(shards: list, mul=matmul) -> list:
    """Fill the None entries of 14 equal-length shard rows from the first
    10 present ones (klauspost's Reconstruct)."""
    present = [i for i, s in enumerate(shards) if s is not None][:DATA_SHARDS]
    if len(present) < DATA_SHARDS:
        raise ValueError("fewer than 10 shards present")
    gen = generator()
    data = mul(invert(gen[present]), np.stack([shards[i] for i in present]))
    full = mul(gen, data)
    return [full[i] if s is None else s for i, s in enumerate(shards)]


def shard_size(dat_size: int) -> int:
    """Bytes in each shard file of a .dat of ``dat_size`` bytes."""
    n_large, rest = 0, dat_size
    while rest > LARGE_BLOCK * DATA_SHARDS:
        n_large += 1
        rest -= LARGE_BLOCK * DATA_SHARDS
    n_small = -(-rest // (SMALL_BLOCK * DATA_SHARDS))
    return n_large * LARGE_BLOCK + n_small * SMALL_BLOCK


def stripe(dat: bytes) -> np.ndarray:
    """The 10 data shards of ``dat``: (10, shard_size) bytes."""
    size = shard_size(len(dat))
    buf = np.frombuffer(dat, dtype=np.uint8)
    out = np.zeros((DATA_SHARDS, size), dtype=np.uint8)
    pos = col = 0
    while len(buf) - pos > LARGE_BLOCK * DATA_SHARDS:
        rows = buf[pos:pos + LARGE_BLOCK * DATA_SHARDS].reshape(DATA_SHARDS, LARGE_BLOCK)
        out[:, col:col + LARGE_BLOCK] = rows
        pos, col = pos + LARGE_BLOCK * DATA_SHARDS, col + LARGE_BLOCK
    tail = np.zeros((size - col) * DATA_SHARDS, dtype=np.uint8)
    tail[:len(buf) - pos] = buf[pos:]
    out[:, col:] = tail.reshape(-1, DATA_SHARDS, SMALL_BLOCK).transpose(1, 0, 2).reshape(
        DATA_SHARDS, -1)
    return out


def unstripe(data_shards: np.ndarray, dat_size: int) -> bytes:
    """The first ``dat_size`` bytes of the .dat the 10 data shards hold."""
    size = data_shards.shape[1]
    parts, col, left = [], 0, dat_size
    while left > LARGE_BLOCK * DATA_SHARDS and size - col > LARGE_BLOCK:
        parts.append(data_shards[:, col:col + LARGE_BLOCK].tobytes())
        col, left = col + LARGE_BLOCK, left - LARGE_BLOCK * DATA_SHARDS
    rows = data_shards[:, col:].reshape(DATA_SHARDS, -1, SMALL_BLOCK).transpose(1, 0, 2)
    parts.append(rows.tobytes())
    return b"".join(parts)[:dat_size]


def encode_dat(dat: bytes, mul=matmul) -> np.ndarray:
    """All 14 shards of ``dat``: (14, shard_size) bytes."""
    data = stripe(dat)
    return np.concatenate([data, mul(PARITY_ROWS, data)])
