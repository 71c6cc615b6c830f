"""The GF(2^8) kernel's algebra and its host-built masks, checked on the CPU.

The CUDA kernel (``seaweedfs_tpu_torch/csrc/gf_matmul.cu``) reads the matrix
as per-(r, j) bit masks (``gf_matmul.coef_masks``: bit d of ``masks[r, j]``
is bit j of ``M[r, d]``) and evaluates every output row by Horner's rule over
the coefficient bits, four bytes to a 32-bit word, taking the data rows in
chunks of ``gf_matmul.CHUNK`` and XORing the chunks' partial rows. The model
below repeats that word arithmetic in numpy. The masks and the model must
both give the product built from the JAX package's multiplication table
(``seaweedfs_tpu.ec.gf.mul_table``), byte for byte: GF(2^8) arithmetic is
exact, so the tolerance is 0.
"""

import numpy as np
import pytest

from seaweedfs_tpu.ec import gf as jgf
from seaweedfs_tpu.ec.codec import NumpyCodec
from seaweedfs_tpu_torch.ec import encoder
from seaweedfs_tpu_torch.ec.codec import get_codec
from seaweedfs_tpu_torch.ec.gf_matmul import CHUNK, coef_masks

MUL = jgf.mul_table()
THREAD_BYTES = 32  # columns a thread owns (kBytes in the source)
WIDTHS = [1, 15, 37, 100]


def reference(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[r] = XOR_d MUL[M[r, d], data[d]]."""
    out = np.zeros((matrix.shape[0], data.shape[1]), dtype=np.uint8)
    for r in range(matrix.shape[0]):
        for d in range(matrix.shape[1]):
            out[r] ^= MUL[matrix[r, d]][data[d]]
    return out


def from_masks(masks: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The product the masks stand for: XOR over the set bits (j, d) of
    masks[r, j] of data[d] * 2^j."""
    out = np.zeros((masks.shape[0], data.shape[1]), dtype=np.uint8)
    for r in range(masks.shape[0]):
        for j in range(8):
            for d in range(data.shape[0]):
                if (int(masks[r, j]) >> d) & 1:
                    out[r] ^= MUL[1 << j][data[d]]
    return out


def xtime4(v: np.ndarray) -> np.ndarray:
    """Doubling of four packed bytes: (v << 1) with each byte's carry
    dropped, XOR 0x1d in each byte whose top bit was set (the PRMT
    sign-replicate of the kernel)."""
    sign = ((v >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(0xFF)
    return ((v << np.uint32(1)) & np.uint32(0xFEFEFEFE)) ^ (sign & np.uint32(0x1D1D1D1D))


def kernel_model(masks: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The kernel's word arithmetic: bytes past n read as 0; per chunk of
    CHUNK data rows, Horner over j from 7 down to 0 per output row; the
    first chunk stores, later ones XOR into the output."""
    k, n = data.shape
    width = -(-n // THREAD_BYTES) * THREAD_BYTES
    padded = np.zeros((k, width), dtype=np.uint8)
    padded[:, :n] = data
    x = padded.view("<u4")
    out = np.zeros((masks.shape[0], width // 4), dtype="<u4")
    for d0 in range(0, k, CHUNK):
        for r in range(masks.shape[0]):
            acc = np.zeros(width // 4, dtype="<u4")
            for j in range(7, -1, -1):
                if j < 7:
                    acc = xtime4(acc)
                m = (int(masks[r, j]) >> d0) & ((1 << CHUNK) - 1)
                for d in range(min(CHUNK, k - d0)):
                    if (m >> d) & 1:
                        acc ^= x[d0 + d]
            out[r] ^= acc
    return out.view(np.uint8)[:, :n]


def check(matrix: np.ndarray, seed: int) -> None:
    rng = np.random.default_rng(seed)
    masks = coef_masks(matrix)
    assert masks.dtype == np.uint64 and masks.shape == (matrix.shape[0], 8)
    for n in WIDTHS:
        data = rng.integers(0, 256, (matrix.shape[1], n), dtype=np.uint8)
        want = reference(matrix, data)
        assert np.array_equal(from_masks(masks, data), want), n
        assert np.array_equal(kernel_model(masks, data), want), n


def test_xtime4_doubles_every_byte():
    v = np.arange(256, dtype=np.uint8).view("<u4")
    assert np.array_equal(xtime4(v).view(np.uint8), MUL[2])


def test_mask_bit_layout():
    matrix = np.array([[0x01, 0x80, 0x03], [0x00, 0xFF, 0x10]], dtype=np.uint8)
    masks = coef_masks(matrix)
    assert masks[0].tolist() == [0b101, 0b100, 0, 0, 0, 0, 0, 0b010]
    assert masks[1].tolist() == [0b010, 0b010, 0b010, 0b010, 0b110, 0b010, 0b010, 0b010]


@pytest.mark.parametrize("k", [1, 10, 16, 17, 64])
@pytest.mark.parametrize("R", [1, 4, 5, 8, 64])
def test_random_matrices(R, k):
    rng = np.random.default_rng(1000 * R + k)
    check(rng.integers(0, 256, (R, k), dtype=np.uint8), seed=R + k)


@pytest.mark.parametrize("fill", [0x00, 0x01, 0xFF])
def test_constant_matrices(fill):
    for R, k in [(4, 10), (5, 17)]:
        check(np.full((R, k), fill, dtype=np.uint8), seed=fill + R)


def test_rs_10_4_parity_matrix():
    check(jgf.parity_matrix(10, 4), seed=7)


def test_rebuild_matrix_for_lost_0_3_10_13():
    """The composite rebuild matrix of the port's file rebuild path, applied
    to the first ten survivors, regenerates the lost shards."""
    lost = [0, 3, 10, 13]
    present = [s for s in range(14) if s not in lost]
    rows = encoder._rebuild_rows(get_codec(device="cpu"), present, lost)
    check(rows, seed=8)
    rng = np.random.default_rng(9)
    full = NumpyCodec().encode_shards(rng.integers(0, 256, (10, 37), dtype=np.uint8))
    assert np.array_equal(kernel_model(coef_masks(rows), full[present[:10]]), full[lost])
