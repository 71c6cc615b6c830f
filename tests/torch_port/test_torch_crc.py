"""The port's CRC-32C: the native C++ build, its pure-Python table version
and the JAX package's ``crc.new`` agree on every input (byte equality of the
32-bit values), for lengths 0 to 1 MiB, odd lengths and unaligned slices."""

import numpy as np
import pytest

from seaweedfs_tpu.storage import crc as jcrc
from seaweedfs_tpu_torch.storage import crc as pcrc

LENGTHS = [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 63, 64, 65, 1000, 4095, 4097,
           65535, 65536, 65537, 1 << 20]


@pytest.fixture(scope="module")
def blob():
    return np.random.default_rng(21).bytes((1 << 20) + 16)


def test_native_build_is_what_update_runs():
    assert pcrc.implementation() == "native"


@pytest.mark.parametrize("n", LENGTHS)
def test_native_table_and_reference_agree(blob, n):
    data = blob[:n]
    want = jcrc.new(data)
    assert pcrc.native_update(0, data) == want
    assert pcrc.table_update(0, data[:65537]) == jcrc.new(data[:65537])
    assert pcrc.new(data) == want
    assert pcrc.masked_value(pcrc.new(data)) == jcrc.masked_value(want)


@pytest.mark.parametrize("start", [1, 3, 5, 7])
def test_unaligned_memoryview_slices(blob, start):
    """Slices at odd offsets, as bytes, memoryview, bytearray and uint8
    array: the native call reads the buffer in place."""
    for n in (1, 9, 4097, 65537):
        view = memoryview(blob)[start:start + n]
        want = jcrc.new(bytes(view))
        assert pcrc.update(0, view) == want
        assert pcrc.update(0, bytearray(view)) == want
        assert pcrc.update(0, np.frombuffer(blob, dtype=np.uint8)[start:start + n]) == want
        assert pcrc.table_update(0, view) == want


def test_incremental_update_matches_one_shot(blob):
    data = blob[:200_001]
    crc = 0
    for lo in range(0, len(data), 7777):
        crc = pcrc.update(crc, data[lo:lo + 7777])
    assert crc == jcrc.new(data)
    assert pcrc.update(jcrc.new(data[:5]), data[5:1000]) == jcrc.update(jcrc.new(data[:5]), data[5:1000])
