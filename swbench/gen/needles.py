"""Needles of the warm-storage mix, from a seed.

Sizes are log-uniform in [lo, hi] bytes, drawn until their records fill a
volume of ``fill`` bytes; the run's seed draws the sizes, the bytes and the
cookies, so every seed lays out a volume of its own.
"""

from __future__ import annotations

import numpy as np

from ..reference.needle import SUPER_BLOCK, record_length


def sizes(fill: int, lo: int, hi: int, seed: int) -> list:
    """Payload sizes whose POSTed records fill ``fill`` bytes of .dat."""
    rng = np.random.default_rng([seed, 1])
    out, total = [], SUPER_BLOCK
    while total < fill:
        n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        out.append(n)
        total += record_length(n)
    return out


class Needles:
    """The needles of one run: ``lens`` (the sizes), ``payload(i)``,
    ``cookie(i)``; ``key(i)`` is ``i + 1``."""

    def __init__(self, seed: int, fill: int, lo: int, hi: int):
        self.lens = sizes(fill, lo, hi, seed)
        rng = np.random.default_rng([seed, 2])
        self.cookies = [int(c) for c in rng.integers(1, 1 << 32, len(self.lens))]
        self.offsets = np.concatenate([[0], np.cumsum(self.lens)])
        self._bytes = np.random.default_rng([seed, 3]).bytes(int(self.offsets[-1]))

    def __len__(self) -> int:
        return len(self.lens)

    def payload(self, i: int) -> bytes:
        return self._bytes[int(self.offsets[i]):int(self.offsets[i + 1])]

    def cookie(self, i: int) -> int:
        return self.cookies[i]

    @staticmethod
    def key(i: int) -> int:
        return i + 1


def fid(vid: int, key: int, cookie: int) -> str:
    """SeaweedFS's file id text: the volume, then the needle key's bytes in
    hex without its leading zero bytes, then the cookie in 8 hex digits."""
    return f"{vid},{key.to_bytes(8, 'big').lstrip(bytes(1)).hex()}{cookie:08x}"
