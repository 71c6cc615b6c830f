"""The CSV structural index on the card: the wrapper of ``csrc/csv_index.cu``.

``index(staged, n, cols, row_batch)`` indexes the first ``n`` bytes of a
segment body already staged on a CUDA device (``ScanPlan``'s pad: the body,
then zeros) and returns a ``CardIndex``: the non-blank rows' starts and ends,
each referenced field's ``(start, len, present)`` vectors, the rows marked
exact, and each batch's field widths, the same values as the host's numpy
index (``ScanPlan._host_index`` and ``_field_vectors``, the plain version,
which the ``cpu`` backend runs and the tests hold the kernel to). See the
source's header for the design and the bound.

On the stream: the widths pass (a memset and three kernels), then one small
copy back, the host's one wait for the card a segment (the row count, the
exact count and the widths), then the rows pass (one kernel) and one
asynchronous copy of the rows into pinned memory. ``CardIndex.rows`` waits
for that copy, which the tree's first ``to_host`` has waited for already.
The field vectors stay on the card, where the tree reads them.

The library is built with ``nvcc`` at first use (``util.nvcc``) and loaded
with ctypes; nothing is built at import.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..util import nvcc
from ..util.locks import make_lock

SOURCE = nvcc.source("csv_index.cu")
TILE = 4096  # kTile in the source: bytes a block
MAX_FIELDS = 256  # kMaxFields in the source: referenced fields a plan
MAX_BYTES = 2**31 - 1 - 2 * TILE  # the source's args_ok: int32 offsets, tiles and all
# bytes the kernel may read past n: its 16-byte loads of the last chunk
OVERREAD = 16

_lib = None
_lib_lock = make_lock("csv_index._lib_lock")
# request threads of the volume server index concurrently, and ``+=`` on
# the counter is a read-modify-write
_count_lock = make_lock("csv_index._count_lock")


def build(verbose: bool = False) -> str:
    """Compile ``csv_index.cu`` into ``csrc/build/`` (``util.nvcc.build``).
    Returns the library's path; ``verbose`` prints ptxas's registers and
    spills."""
    return nvcc.build(SOURCE, verbose)


def _load():
    global _lib
    with _lib_lock:  # the two streams' first queries would build it twice
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.csv_index_widths.argtypes = [p, ll, p, i, i, p, p, i, p]
            lib.csv_index_rows.argtypes = [p, ll, p, i, i, p, p, p, i, p]
            lib.csv_index_widths.restype = lib.csv_index_rows.restype = ctypes.c_int
            _lib = lib
    return _lib


@dataclass
class CardIndex:
    """One segment's index. ``vecs`` is int32 ``[fields, 3, nrows]`` on the
    card; ``widths[b, f]`` is field f's largest length in batch b (rows
    ``[b * row_batch, (b + 1) * row_batch)``); ``host_rows`` is int32
    ``[3, nrows]`` (start, end, exact) in pinned host memory, complete once
    ``ready`` has completed (None: no rows, nothing to wait for)."""

    nrows: int
    nexact: int
    widths: np.ndarray
    vecs: torch.Tensor
    host_rows: torch.Tensor
    ready: Optional[torch.cuda.Event]

    def rows(self, lo: int, hi: int):
        """(starts, ends, exact) of rows ``[lo, hi)`` as host arrays."""
        if self.ready is not None:
            self.ready.synchronize()
        h = self.host_rows.numpy()
        return h[0, lo:hi], h[1, lo:hi], h[2, lo:hi] != 0


def index(staged: torch.Tensor, n: int, cols, row_batch: int) -> CardIndex:
    """Index the first ``n`` bytes of ``staged`` (uint8, 1-D, contiguous, on
    a CUDA device, at least ``n + OVERREAD`` bytes, bytes past ``n`` not
    newlines, no quote or CR before ``n``). ``cols[f]`` is field f's header
    column, -1 where the header lacks it; ``row_batch`` the tree's rows a
    batch. Each kernel launched adds one to ``index.launches``: three for
    the widths pass, one for the rows pass."""
    if staged.device.type != "cuda":
        raise ValueError(f"csv_index runs on cuda tensors, not {staged.device}")
    if staged.dtype != torch.uint8 or staged.dim() != 1 or not staged.is_contiguous():
        raise ValueError(f"staged: want a contiguous 1-D uint8 tensor, got {staged.dtype} "
                         f"{tuple(staged.shape)}")
    if not 1 <= n <= staged.numel() - OVERREAD or staged.data_ptr() % 16:
        raise ValueError(f"staged: want {n} bytes and {OVERREAD} more, 16-byte aligned; got "
                         f"{staged.numel()} at {staged.data_ptr():#x}")
    colarr = np.ascontiguousarray(cols, dtype=np.int32)
    nf = len(colarr)
    if not 1 <= nf <= MAX_FIELDS:
        raise ValueError(f"csv_index takes 1 to {MAX_FIELDS} fields, got {nf}")
    dev = staged.device
    tiles = -(-n // TILE)
    max_batches = max(1, -(-((n + 1) // 2) // row_batch))  # (n + 1) // 2 rows at most
    off = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    meta = torch.empty(2 + max_batches * nf, dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csv_index_widths(staged.data_ptr(), n, colarr.ctypes.data, nf, row_batch,
                                   off.data_ptr(), meta.data_ptr(), max_batches, stream)
        if err != 0:
            raise RuntimeError(f"csv_index_widths launch failed: CUDA error {err}")
        _count(3)
        head = meta.cpu().numpy()  # the one wait for the card
        nrows, nexact = int(head[0]), int(head[1])
        widths = head[2: 2 + nf * -(-nrows // row_batch)].reshape(-1, nf)
        vecs = torch.empty((nf, 3, nrows), dtype=torch.int32, device=dev)
        host_rows, ready = torch.empty((3, 0), dtype=torch.int32), None
        if nrows:
            rows = torch.empty((3, nrows), dtype=torch.int32, device=dev)
            err = lib.csv_index_rows(staged.data_ptr(), n, colarr.ctypes.data, nf, row_batch,
                                     off.data_ptr(), vecs.data_ptr(), rows.data_ptr(), nrows,
                                     stream)
            if err != 0:
                raise RuntimeError(f"csv_index_rows launch failed: CUDA error {err}")
            _count(1)
            host_rows = torch.empty((3, nrows), dtype=torch.int32, pin_memory=True)
            host_rows.copy_(rows, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
    return CardIndex(nrows, nexact, widths, vecs, host_rows, ready)


index.launches = 0


def _count(kernels: int) -> None:
    with _count_lock:
        index.launches += kernels
