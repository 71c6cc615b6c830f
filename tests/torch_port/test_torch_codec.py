"""The port's gf_matmul and codec hold byte for byte against the JAX package.

The JAX side runs its Pallas kernel in interpret mode (TpuCodec with
use_pallas=True, pallas_interpret=True), as tests/test_ec_codec.py does, and
its NumpyCodec where many cases make interpret mode too slow. GF(2^8)
arithmetic is exact, so every comparison is byte equality (tolerance 0).
"""

import itertools
import sys
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.codec import NumpyCodec, TpuCodec
from seaweedfs_tpu_torch.ec import codec as pcodec
from seaweedfs_tpu_torch.ec.codec import Codec, CpuCodec, CudaCodec, get_codec
from seaweedfs_tpu_torch.ec.gf_matmul import CHUNK, gf_matmul, gf_matmul_plain

WIDTHS = [1, 7, 777, 4096, 5000, 65537]
GEOMETRIES = [(10, 4), (6, 3), (12, 4)]


@pytest.fixture(scope="module")
def pallas():
    return TpuCodec(chunk_bytes=16 * 1024, tile_bytes=4096, use_pallas=True,
                    pallas_tile=4096, pallas_interpret=True)


@pytest.fixture(scope="module")
def port():
    return get_codec(device="cpu")


@pytest.mark.parametrize("width", WIDTHS)
def test_encode_matches_pallas_kernel(pallas, port, width):
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, (10, width), dtype=np.uint8)
    assert np.array_equal(port.encode(data), pallas.encode(data))


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_gf_matmul_matches_pallas_kernel(pallas, rows):
    """gf_matmul on CPU tensors with arbitrary coefficient rows (R = 1..4,
    the rebuild and reconstruct shapes) equals TpuCodec.matmul."""
    rng = np.random.default_rng(40 + rows)
    matrix = rng.integers(0, 256, (rows, 10), dtype=np.uint8)
    data = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
    got = gf_matmul(matrix, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), pallas.matmul(matrix, data))


def test_reconstruct_matches_pallas_kernel(pallas, port):
    rng = np.random.default_rng(9)
    full = NumpyCodec().encode_shards(rng.integers(0, 256, (10, 4096), dtype=np.uint8))
    lost = [0, 1, 4, 13]
    a = [None if i in lost else full[i].copy() for i in range(14)]
    b = [None if i in lost else full[i].copy() for i in range(14)]
    port.reconstruct(a)
    pallas.reconstruct(b)
    for i in range(14):
        assert np.array_equal(a[i], b[i]) and np.array_equal(a[i], full[i]), i


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_alt_geometries(k, m):
    rng = np.random.default_rng(k)
    ref = NumpyCodec(k, m)
    pallas = TpuCodec(k, m, chunk_bytes=16 * 1024, tile_bytes=4096, use_pallas=True,
                      pallas_tile=4096, pallas_interpret=True)
    port = get_codec(k, m, device="cpu")
    assert np.array_equal(port.matrix, pallas.matrix)
    data = rng.integers(0, 256, (k, 3001), dtype=np.uint8)
    full = ref.encode_shards(data)
    assert np.array_equal(port.encode(data), pallas.encode(data))
    assert np.array_equal(port.encode_shards(data), full)
    lost = list(range(0, k + m, max(1, (k + m) // m)))[:m]
    shards = [None if i in lost else full[i].copy() for i in range(k + m)]
    port.reconstruct(shards)
    assert all(np.array_equal(shards[i], full[i]) for i in range(k + m))


@pytest.mark.parametrize("first", [0, 1, 2, 3, 4])
def test_every_four_shard_loss(port, first):
    """All 1001 four-of-fourteen losses (split by lowest lost shard so the
    cases spread over workers), against NumpyCodec."""
    rng = np.random.default_rng(first)
    ref = NumpyCodec()
    full = ref.encode_shards(rng.integers(0, 256, (10, 37), dtype=np.uint8))
    combos = [c for c in itertools.combinations(range(14), 4)
              if c[0] == first or (first == 4 and c[0] >= 4)]
    for lost in combos:
        shards = [None if i in lost else full[i] for i in range(14)]
        port.reconstruct(shards)
        for i in lost:
            assert np.array_equal(shards[i], full[i]), (lost, i)


def test_reconstruct_data_and_verify(port):
    rng = np.random.default_rng(11)
    ref = NumpyCodec()
    full = ref.encode_shards(rng.integers(0, 256, (10, 999), dtype=np.uint8))
    shards = [None if i in (2, 7, 11) else full[i].copy() for i in range(14)]
    got = port.reconstruct_data(list(shards))
    want = ref.reconstruct_data(list(shards))
    assert got[11] is None and want[11] is None
    for i in range(10):
        assert np.array_equal(got[i], want[i])
    assert port.verify(full)
    bad = full.copy()
    bad[12, 100] ^= 1
    assert not port.verify(bad)
    assert port.verify(full) == ref.verify(full) and port.verify(bad) == ref.verify(bad)


def test_from_matrix_carries_the_jax_codec_state(pallas):
    rng = np.random.default_rng(12)
    port = Codec.from_matrix(pallas.matrix, device="cpu")
    assert isinstance(port, CpuCodec)
    assert (port.data_shards, port.parity_shards) == (10, 4)
    data = rng.integers(0, 256, (10, 4096), dtype=np.uint8)
    assert np.array_equal(port.encode(data), pallas.encode(data))
    with pytest.raises(ValueError):
        Codec.from_matrix(pallas.matrix[::-1], device="cpu")  # not systematic


def test_get_codec_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        get_codec()
    with pytest.raises(RuntimeError):
        CudaCodec()
    with pytest.raises(ValueError):
        CudaCodec(device="cpu")
    assert isinstance(get_codec(device="cpu"), CpuCodec)
    assert get_codec(device="cpu").device.type == "cpu"


def test_device_api_on_cpu(port):
    """The duck-typed device API the encoder drives, on CPU tensors."""
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, (10, 1000), dtype=np.uint8)
    data.flags.writeable = False  # as np.frombuffer(bytes) gives
    assert port.alignment() == 1
    assert port.device_memory_free() is None
    dev = port.device_put(data)
    out = port.matmul_device(port.parity_rows, dev)
    buf = port.host_buffer(4 * 1000)
    got = port.to_host(out, port.record_ready(), buf)
    assert np.array_equal(got, NumpyCodec().encode(np.array(data)))


def test_wrapper_validates_inputs():
    m = np.zeros((4, 10), dtype=np.uint8)
    with pytest.raises(ValueError):
        gf_matmul(torch.from_numpy(m), torch.zeros((10, 16), dtype=torch.uint8))  # not host
    with pytest.raises(ValueError):
        gf_matmul(m.astype(np.int32), torch.zeros((10, 16), dtype=torch.uint8))  # dtype
    with pytest.raises(ValueError):
        gf_matmul(m, torch.zeros((9, 16), dtype=torch.uint8))  # k mismatch
    with pytest.raises(ValueError):
        gf_matmul(m, torch.zeros((10, 16), dtype=torch.int32))  # dtype
    with pytest.raises(ValueError):
        gf_matmul(m, torch.zeros((16, 10), dtype=torch.uint8).t())  # column-major rows
    with pytest.raises(ValueError):
        gf_matmul(m, torch.zeros((10, 16), dtype=torch.uint8),
                  out=torch.zeros((4, 15), dtype=torch.uint8))
    # a column slice (row stride > width) is taken, and written into a slice
    rng = np.random.default_rng(14)
    wide = torch.from_numpy(rng.integers(0, 256, (10, 100), dtype=np.uint8))
    coef = rng.integers(0, 256, (4, 10), dtype=np.uint8)
    out = torch.zeros((4, 120), dtype=torch.uint8)
    gf_matmul(coef, wide[:, 5:65], out=out[:, 10:70])
    want = NumpyCodec().matmul(coef, np.ascontiguousarray(wide[:, 5:65].numpy()))
    assert np.array_equal(out[:, 10:70].numpy(), want)
    assert not out[:, :10].any() and not out[:, 70:].any()


def test_cpu_tensors_never_count_a_launch(port):
    before = gf_matmul.launches
    port.encode(np.ones((10, 64), dtype=np.uint8))
    assert gf_matmul.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The CUDA kernel against its plain version at ragged widths, strided
    and unaligned layouts, for R > 4, k at and past the kernel's 16-row chunk
    and k = 1 (runs only where there is a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    for R, k in [(4, 10), (1, 10), (3, 6), (4, 12), (8, 10), (16, 10), (4, 16), (4, 17),
                 (64, 64), (4, 1)]:
        matrix = rng.integers(0, 256, (R, k), dtype=np.uint8)
        for n in (1, 15, 16, 17, 4099, 65537):
            wide = torch.empty((k, n + 7), dtype=torch.uint8, device="cuda").random_(generator=gen)
            for data in (wide[:, :n].contiguous(), wide[:, 3:3 + n]):
                before = gf_matmul.launches
                got = gf_matmul(matrix, data)
                assert gf_matmul.launches == before + -(-k // CHUNK)  # one per 16 data rows
                torch.cuda.synchronize()
                assert torch.equal(got, gf_matmul_plain(matrix, data)), (R, k, n)
    codec = pcodec.get_codec()
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (10, 70001), dtype=np.uint8)
    assert np.array_equal(codec.encode(data), NumpyCodec().encode(data))


@pytest.mark.cuda
def test_launch_counter_counts_every_thread():
    """Request threads of the volume server share one CudaCodec: eight
    threads each reconstruct through it (host in, host out, as a degraded
    read does), every result is right and no launch goes uncounted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    codec = pcodec.get_codec()
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (10, 65537), dtype=np.uint8)
    want = NumpyCodec().encode(data)
    per_thread, threads = 50, 8
    errors = []

    def work():
        for _ in range(per_thread):
            if not np.array_equal(codec.encode(data), want):
                errors.append("parity differs")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = gf_matmul.launches
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert gf_matmul.launches - before == threads * per_thread  # k = 10: one launch each
