"""The plain reference against known vectors, its definitions, and the port."""

import struct

import numpy as np
import pytest

from swbench.gen import lineitem, needles
from swbench.reference import needle as ref_needle
from swbench.reference import q6, rs

Q6 = {"shipdate_from": "1994-01-01", "shipdate_to": "1995-01-01", "discount_lo": 0.05,
      "discount_hi": 0.07, "quantity_below": 24}


def test_exp_table_is_the_field_of_0x11d():
    x, want = 1, []
    for _ in range(255):
        want.append(x)
        x <<= 1
        if x & 0x100:
            x ^= 0x11D
    assert rs.EXP.tolist() == want


def test_parity_rows_are_klauspost_inverted_vandermonde():
    def power(a, n):
        out = 1
        for _ in range(n):
            out = int(rs.MUL[out, a])
        return out

    vm = np.array([[power(r, c) for c in range(10)] for r in range(14)], dtype=np.uint8)
    inv = rs.invert(vm[:10])
    gen = np.zeros((14, 10), dtype=np.uint8)
    for r in range(14):
        for c in range(10):
            acc = 0
            for k in range(10):
                acc ^= int(rs.MUL[vm[r, k], inv[k, c]])
            gen[r, c] = acc
    assert np.array_equal(gen[:10], np.eye(10, dtype=np.uint8))
    assert np.array_equal(gen[10:], rs.PARITY_ROWS)


def test_gf_known_products():
    assert rs.MUL[2, 0x80] == 0x1D  # x * x^7 = x^8 = x^4 + x^3 + x^2 + 1
    assert all(rs.MUL[a, rs.INV[a]] == 1 for a in range(1, 256))


def test_reconstruct_any_four_lost():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (10, 777), dtype=np.uint8)
    full = np.concatenate([data, rs.matmul(rs.PARITY_ROWS, data)])
    for lost in ([0, 3, 10, 13], [1, 5, 9, 13], [6, 7, 8, 9]):
        got = rs.reconstruct([None if i in lost else full[i] for i in range(14)])
        assert all(np.array_equal(got[i], full[i]) for i in range(14))


def test_xor_control_loses_what_rs_recovers():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (10, 512), dtype=np.uint8)
    full = rs.encode_dat(data.tobytes())
    got = rs.reconstruct([None if i in (0, 3, 10, 13) else full[i] for i in range(14)],
                         mul=rs.matmul_xor)
    assert not np.array_equal(got[0], full[0])


def test_stripe_layout():
    dat = bytes(range(256)) * 50_000  # 12.2 MiB: two rows of 10 x 1 MiB
    shards = rs.stripe(dat)
    assert shards.shape == (10, 2 << 20)
    assert shards[3, :1 << 20].tobytes() == dat[3 << 20:4 << 20]
    assert shards[0, 1 << 20:].tobytes() == dat[10 << 20:11 << 20]
    assert rs.unstripe(shards, len(dat)) == dat
    assert rs.shard_size(10 << 30) == 1 << 30  # one full large row is not "more than one"
    assert rs.shard_size((10 << 30) + 1) == (1 << 30) + (1 << 20)


def test_crc32c_known_vectors():
    got = ref_needle.crc32c([b"123456789", b"", bytes(32), bytes(range(32))])
    assert [int(x) for x in got] == [0xE3069283, 0, 0x8A9136AA, 0x46DD794E]


def test_crc32c_long_and_many():
    rng = np.random.default_rng(5)
    payloads = [rng.bytes(int(n)) for n in (1, 1023, 1024, 1025, 70_000)]

    def bitwise(b):
        c = 0xFFFFFFFF
        for byte in b:
            c ^= byte
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        return c ^ 0xFFFFFFFF

    assert [int(x) for x in ref_needle.crc32c(payloads)] == [bitwise(p) for p in payloads]


def test_needle_volume_matches_the_port():
    from seaweedfs_tpu_torch.storage.needle import FLAG_HAS_LAST_MODIFIED, Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock

    ns = needles.Needles(seed=9, fill=300_000, lo=1024, hi=65536)
    times = [(1_700_000_000 + i, 1_700_000_000_000_000_000 + 7 * i) for i in range(len(ns))]
    want = [SuperBlock(version=3).to_bytes()]
    for i, (lm, at) in enumerate(times):
        n = Needle(cookie=ns.cookie(i), id=ns.key(i), data=ns.payload(i))
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
        n.last_modified, n.append_at_ns = lm, at
        want.append(n.to_bytes(3))
    got = ref_needle.volume([(ns.cookie(i), ns.key(i), ns.payload(i)) for i in range(len(ns))],
                            times)
    assert got == b"".join(want)
    for (a, b), (lm, at) in zip(ref_needle.time_fields(ns.lens), times):
        assert int.from_bytes(got[a:a + 5], "big") == lm
        assert struct.unpack(">Q", got[b:b + 8])[0] == at


def test_needles_come_from_the_seed():
    a = needles.Needles(seed=1, fill=2 << 20, lo=1024, hi=1 << 20)
    b = needles.Needles(seed=2**31 + 7, fill=2 << 20, lo=1024, hi=1 << 20)
    again = needles.Needles(seed=2**31 + 7, fill=2 << 20, lo=1024, hi=1 << 20)
    assert a.lens != b.lens and a.payload(0) != b.payload(0)
    assert (b.lens, b.cookies, b.payload(3)) == (again.lens, again.cookies, again.payload(3))
    for ns in (a, b):
        assert all(1024 <= n <= 1 << 20 for n in ns.lens)
        fill = needles.SUPER_BLOCK + sum(needles.record_length(n) for n in ns.lens)
        assert fill >= 2 << 20 > fill - needles.record_length(ns.lens[-1])


def test_fid_text_matches_the_port():
    from seaweedfs_tpu_torch.storage.file_id import FileId

    for key in (1, 0x1F, 0x100, 0x12345, 2**40):
        assert needles.fid(3, key, 0xABC) == str(FileId(3, key, 0xABC))


def test_lineitem_rows():
    data = lineitem.lineitem_csv(2**31 + 3, 1, 1 << 20)
    lines = data.decode().split("\n")
    assert lines[0].split(",") == list(lineitem.COLUMNS) and lines[-1] == ""
    rows = [ln.split(",") for ln in lines[1:-1]]
    assert len(data) <= 1 << 20 and all(len(r) == 16 for r in rows)
    for r in rows[:2000]:
        assert 1 <= int(r[4]) <= 50 and r[6] in {f"0.{d:02d}" for d in range(11)}
        assert r[10] < r[12] and "1992-01-02" <= r[10] <= "1998-12-01"
        assert r[8] in "RAN" and r[9] in "FO" and 10 <= len(r[15]) <= 43
    assert data == lineitem.lineitem_csv(2**31 + 3, 1, 1 << 20)


def test_q6_matches_the_ports_row_engine():
    from seaweedfs_tpu_torch.query import parse_sql, run_query

    data = lineitem.lineitem_csv(11, 0, 1 << 20)
    select, where, limit = parse_sql(q6.sql(Q6))
    want = [tuple(r[k] for k in q6.PROJECT)
            for r in run_query(data, "csv", select, where, limit)]
    got = q6.rows(data, Q6)
    assert got == want and len(got) > 50


@pytest.mark.parametrize("narrow", [False, True])
def test_q6_control_reads_float32(narrow):
    data = lineitem.lineitem_csv(12, 0, 1 << 20)
    full = q6.rows(data, Q6)
    got = q6.rows(data, Q6, q6.narrow if narrow else float)
    # float32(0.07) > 0.07: the control drops every row at the upper bound
    assert (got == full) is not narrow
