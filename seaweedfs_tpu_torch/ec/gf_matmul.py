"""GF(2^8) matrix product: the CUDA kernel, its plain PyTorch version, the
build step and the launch counter.

``gf_matmul(matrix[R, k], data[k, n])`` returns ``out[R, n]`` with
``out[p, c] = XOR_d gf_mul(matrix[p, d], data[d, c])`` over GF(2^8), poly
0x11D: the function of the TPU kernel ``build_pallas_gf_matmul``
(seaweedfs_tpu/ec/codec.py:207). On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/gf_matmul.cu`` (see its header for the design
and the bound) or raises; on a CPU tensor it runs the plain version. There is
no fallback from one to the other.

The matrix is a host array. The kernel reads it as per-(r, j) bit masks
(``coef_masks``), built on the host once per matrix and passed by value at
launch, so no launch copies coefficients to or from the card.

The kernel is compiled with ``nvcc`` at first use into ``csrc/build/`` and
loaded with ctypes; nothing is built at import, so the module imports where
there is no CUDA toolkit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..util import nvcc
from ..util.locks import make_lock
from . import gf

SOURCE = nvcc.source("gf_matmul.cu")
MAX_ROWS = MAX_COLS = 64  # kMaxRows / kMaxCols in the source
CHUNK = 16  # kChunk in the source: data rows per launch

# The plain version walks columns in tiles so the 8x-expanded bit planes stay
# bounded (4 MiB columns x 8k planes x 2 or 4 bytes), as TpuCodec._kernel's
# fori_loop over tile_bytes does.
PLAIN_TILE = 4 * 1024 * 1024

_launch = None
_lib_lock = make_lock("gf_matmul._lib_lock")
# request threads of the volume server launch concurrently, and ``+=`` on
# the counter is a read-modify-write
_count_lock = make_lock("gf_matmul._count_lock")


def build(verbose: bool = False) -> str:
    """Compile ``gf_matmul.cu`` into ``csrc/build/`` (``util.nvcc.build``).
    Returns the library's path; ``verbose`` prints ptxas's registers and
    spills."""
    return nvcc.build(SOURCE, verbose)


def _load():
    global _launch
    with _lib_lock:
        if _launch is None:
            fn = ctypes.CDLL(build()).gf_matmul_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _launch = fn
    return _launch


def coef_masks(matrix: np.ndarray) -> np.ndarray:
    """The kernel's view of a GF matrix: uint64[R, 8] with bit d of
    ``masks[r, j]`` set when bit j of ``matrix[r, d]`` is (k <= 64)."""
    m = np.asarray(matrix, dtype=np.uint8)
    if m.ndim != 2 or m.shape[1] > 64:
        raise ValueError(f"want an R x k matrix with k <= 64, got {m.shape}")
    bits = (m[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1  # (R, 8, k)
    weights = np.uint64(1) << np.arange(m.shape[1], dtype=np.uint64)
    return np.bitwise_or.reduce(bits.astype(np.uint64) * weights, axis=2,
                                initial=np.uint64(0)).astype(np.uint64)


_mask_cache: dict = {}


def _masks(matrix: np.ndarray) -> np.ndarray:
    """``coef_masks`` of ``matrix``, cached per matrix (the counterpart of
    ``TpuCodec._bitmat``)."""
    key = (matrix.shape, matrix.tobytes())
    cached = _mask_cache.get(key)
    if cached is None:
        cached = _mask_cache[key] = coef_masks(matrix)
    return cached


def _check_matrix(matrix: np.ndarray) -> None:
    if not isinstance(matrix, np.ndarray) or matrix.dtype != np.uint8 or matrix.ndim != 2:
        raise ValueError("matrix: want a 2-D uint8 np.ndarray on the host, "
                         f"got {type(matrix).__name__}")


def _check_rows(name: str, t: torch.Tensor) -> None:
    """2-D uint8 with contiguous rows; the row stride may exceed the width
    (a column slice of a wider matrix)."""
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"{name}: want a 2-D uint8 tensor, got {t.dtype} {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous (stride {t.stride()})")
    if t.shape[0] > 1 and t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: overlapping rows (stride {t.stride()})")


def gf_matmul(matrix: np.ndarray, data: torch.Tensor,
              out: "torch.Tensor | None" = None, accumulate: bool = False) -> torch.Tensor:
    """(R x k GF matrix) @ (k x n bytes) -> (R x n bytes), on data's device.

    ``matrix`` is a host uint8 np.ndarray, whatever the device of ``data``.
    ``data`` and ``out`` are uint8 with contiguous rows (see _check_rows).
    With ``accumulate`` the product is XORed into ``out`` (which must be
    given) instead of replacing it: GF(2^8) addition, so partial products
    over disjoint slices of the contraction sum to the whole.
    On CUDA the kernels go on the current stream, one per CHUNK data rows,
    and each adds one to ``gf_matmul.launches`` (under a lock: any thread
    may launch)."""
    _check_matrix(matrix)
    _check_rows("data", data)
    R, k = matrix.shape
    if data.shape[0] != k:
        raise ValueError(f"shape mismatch: matrix {matrix.shape} @ data {tuple(data.shape)}")
    n = data.shape[1]
    if out is None:
        if accumulate:
            raise ValueError("accumulate needs an out to XOR into")
        out = torch.empty((R, n), dtype=torch.uint8, device=data.device)
    else:
        _check_rows("out", out)
        if tuple(out.shape) != (R, n) or out.device != data.device:
            raise ValueError(f"out: want ({R}, {n}) on {data.device}, "
                             f"got {tuple(out.shape)} on {out.device}")
    if data.device.type == "cpu":
        if accumulate:
            return out.bitwise_xor_(gf_matmul_plain(matrix, data))
        return gf_matmul_plain(matrix, data, out=out)
    if data.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu tensors, not {data.device}")
    if R > MAX_ROWS or k > MAX_COLS:
        raise ValueError(f"gf_matmul kernel takes R, k <= {MAX_ROWS}; got {R}x{k}")
    if R == 0 or n == 0:
        return out
    masks = _masks(matrix)
    launch = _load()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = launch(masks.ctypes.data, R, k, data.data_ptr(), data.stride(0),
                     out.data_ptr(), out.stride(0), n, int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"gf_matmul launch failed: CUDA error {err}")
    with _count_lock:
        gf_matmul.launches += -(-k // CHUNK)
    return out


gf_matmul.launches = 0


_bitmat_cache: dict = {}


def _plain_dtype(device: torch.device) -> torch.dtype:
    """The plain product's type: float16 on the card, float32 on the CPU.
    Both are exact here: inputs are 0/1 and each sum counts at most 8k
    ones (<= 512 for k <= 64), below 2048, the largest integer run that
    float16 holds exactly, whatever the precision of the accumulation. A
    float16 product is not subject to TF32, so no process-wide flag is
    touched."""
    return torch.float16 if device.type == "cuda" else torch.float32


def _bit_matrix(matrix: np.ndarray, device: torch.device) -> torch.Tensor:
    """GF(2) bit matrix (8R x 8k) on ``device``, cached."""
    key = (matrix.shape, matrix.tobytes(), str(device))
    cached = _bitmat_cache.get(key)
    if cached is None:
        bm = gf.gf_matrix_to_bit_matrix(matrix)
        cached = torch.from_numpy(bm).to(device, _plain_dtype(device))
        _bitmat_cache[key] = cached
    return cached


def gf_matmul_plain(matrix: np.ndarray, data: torch.Tensor,
                    out: "torch.Tensor | None" = None) -> torch.Tensor:
    """The plain PyTorch version, on any device: TpuCodec._kernel's bit
    matmul (seaweedfs_tpu/ec/codec.py:314-329). Unpack bytes to bits with
    shifts, multiply by the GF(2) bit matrix (exactly, see _plain_dtype),
    reduce mod 2, repack. ``matrix`` is a host uint8 np.ndarray."""
    _check_matrix(matrix)
    R, k = matrix.shape
    n = data.shape[1]
    if out is None:
        out = torch.empty((R, n), dtype=torch.uint8, device=data.device)
    bitmat = _bit_matrix(matrix, data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = (torch.ones(8, dtype=torch.int32, device=data.device) << shifts.int())
    for pos in range(0, n, PLAIN_TILE):
        tile = data[:, pos:pos + PLAIN_TILE]
        w = tile.shape[1]
        bits = (tile[:, None, :] >> shifts[None, :, None]) & 1  # (k, 8, w)
        acc = bitmat @ bits.reshape(k * 8, w).to(bitmat.dtype)  # (8R, w)
        obits = acc.int() & 1
        packed = (obits.reshape(R, 8, w) * weights[None, :, None]).sum(1)
        out[:, pos:pos + w] = packed.to(torch.uint8)
    return out
