"""RS codec on PyTorch: encode/reconstruct through the GF(2^8) CUDA kernel.

Computes the same function as the JAX package's codecs — GF(2^8) matmul with
the klauspost-compatible matrix (gf.build_matrix) — so shard bytes are
identical wherever they were computed. Mirrors the reference's use of
`reedsolomon.Encoder` (Encode/Reconstruct/ReconstructData — call sites
`weed/storage/erasure_coding/ec_encoder.go:179,270`,
`weed/storage/store_ec.go:367`).

``CudaCodec`` is the counterpart of the JAX package's ``TpuCodec``: it keeps
the device API that ``encoder.py`` duck-types (``alignment``, ``device_put``,
``matmul_device``, ``device_memory_free``) plus the two calls the port's
pipeline needs to cross threads (``record_ready``, ``to_host``).
``CpuCodec`` offers the same API on CPU tensors, where ``gf_matmul`` takes its
plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import gf
from .constants import DATA_SHARDS, PARITY_SHARDS
from .gf_matmul import gf_matmul


class Codec:
    """Base: shard-count bookkeeping + reconstruct planning (host-side)."""

    def __init__(self, data_shards: int = DATA_SHARDS, parity_shards: int = PARITY_SHARDS,
                 matrix: Optional[np.ndarray] = None):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        if matrix is None:
            matrix = gf.build_matrix(data_shards, self.total_shards)
        self.matrix = matrix
        self.parity_rows = self.matrix[data_shards:]

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, **kwargs) -> "Codec":
        """A codec for an existing (k+m) x k generator matrix — the state an
        EC deployment carries, e.g. the JAX codec's ``.matrix``. Called on
        ``Codec`` itself it builds the codec for ``device`` (default: the
        card); ``kwargs`` go to the constructor."""
        matrix = np.array(matrix, dtype=np.uint8, copy=True)
        if matrix.ndim != 2 or matrix.shape[0] <= matrix.shape[1]:
            raise ValueError(f"want a (k+m) x k generator matrix, got {matrix.shape}")
        k = matrix.shape[1]
        if not np.array_equal(matrix[:k], gf.mat_identity(k)):
            raise ValueError("generator matrix is not systematic (top k rows != identity)")
        target = _codec_class(kwargs.get("device", "cuda")) if cls is Codec else cls
        return target(k, matrix.shape[0] - k, matrix=matrix, **kwargs)

    # -- backend hook --------------------------------------------------------
    def matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        """(R×k GF matrix) @ (k×N bytes) → (R×N bytes). Backend-specific."""
        raise NotImplementedError

    # -- public API ----------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k, N) → parity (m, N)."""
        if data.shape[0] != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data rows, got {data.shape[0]}")
        return self.matmul(self.parity_rows, data)

    def encode_shards(self, data: np.ndarray) -> np.ndarray:
        """data (k, N) → all shards (k+m, N) (data rows pass through)."""
        return np.concatenate([data, self.encode(data)], axis=0)

    def _decode_matrix_for(self, present: Sequence[int]) -> np.ndarray:
        """Inverse of the matrix rows for the first k present shards.

        Mirrors klauspost's Reconstruct: collect valid shards in index order
        until k are found; the decode matrix maps those k shards back to the
        k data shards.
        """
        rows = list(present)[: self.data_shards]
        if len(rows) < self.data_shards:
            raise ValueError(
                f"need {self.data_shards} shards to reconstruct, have {len(rows)}"
            )
        sub = self.matrix[rows]
        return gf.mat_invert(sub)

    def reconstruct(
        self, shards: list[Optional[np.ndarray]], data_only: bool = False
    ) -> list[np.ndarray]:
        """Fill in missing (None) shards in place; returns the full list.

        Bit-identical to klauspost Encoder.Reconstruct / ReconstructData.
        """
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shards")
        present = [i for i, s in enumerate(shards) if s is not None]
        missing = [i for i, s in enumerate(shards) if s is None]
        if not missing:
            return shards  # nothing to do
        if len(present) < self.data_shards:
            raise ValueError("too few shards to reconstruct")

        first_k = present[: self.data_shards]
        sub_data = np.stack([shards[i] for i in first_k])
        missing_data = [i for i in missing if i < self.data_shards]
        missing_parity = [i for i in missing if i >= self.data_shards]

        if missing_data:
            decode = self._decode_matrix_for(first_k)
            rows = decode[missing_data]  # (|md| × k)
            rebuilt = self.matmul(rows, sub_data)
            for j, i in enumerate(missing_data):
                shards[i] = rebuilt[j]

        if missing_parity and not data_only:
            all_data = np.stack([shards[i] for i in range(self.data_shards)])
            rows = self.matrix[missing_parity]
            rebuilt = self.matmul(rows, all_data)
            for j, i in enumerate(missing_parity):
                shards[i] = rebuilt[j]

        return shards

    def reconstruct_data(self, shards: list[Optional[np.ndarray]]) -> list[np.ndarray]:
        """Rebuild only missing data shards (store_ec.go ReconstructData path)."""
        return self.reconstruct(shards, data_only=True)

    def verify(self, shards: np.ndarray) -> bool:
        """Check parity rows match the data rows (klauspost Encoder.Verify)."""
        expect = self.encode(np.asarray(shards[: self.data_shards]))
        return bool(np.array_equal(expect, shards[self.data_shards :]))


def _writable(data: np.ndarray) -> np.ndarray:
    """torch.from_numpy needs a writable C-contiguous array; a read-only one
    (np.frombuffer of bytes) is copied first."""
    if not data.flags.writeable or not data.flags.c_contiguous:
        data = np.array(data, copy=True, order="C")
    return data


class _TorchCodec(Codec):
    """What the card and CPU codecs share: the launch width and the host-in,
    host-out ``matmul`` built on the device API (``device_put``,
    ``matmul_device``, ``record_ready``, ``host_buffer``, ``to_host``) that
    each subclass implements."""

    def __init__(self, *args, device: "str | torch.device",
                 chunk_bytes: int = 32 * 1024 * 1024, **kwargs):
        super().__init__(*args, **kwargs)
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        self.device = torch.device(device)
        self.chunk_bytes = chunk_bytes

    def alignment(self) -> int:
        """Column widths fed to matmul_device must be multiples of this: the
        kernel masks ragged tails itself, so any width goes."""
        return 1

    def matmul(self, matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
        """Host in, host out (Codec.reconstruct / encode)."""
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        if data.shape[0] != matrix.shape[1]:
            raise ValueError(f"shape mismatch {matrix.shape} @ {data.shape}")
        res = self.matmul_device(matrix, self.device_put(data))
        buf = self.host_buffer(matrix.shape[0] * data.shape[1])
        return self.to_host(res, self.record_ready(), buf)


class CudaCodec(_TorchCodec):
    """GF(2^8) matmul through the hand-written CUDA kernel (ec/gf_matmul.py).

    Device work goes on three streams the codec owns: host→device copies
    (``device_put``), kernels (``matmul_device``) and device→host copies
    (``to_host``). They are separate so that, in the encoder's overlap
    pipeline, the copy of chunk i+1 and the fetch of chunk i ride beside the
    kernel of chunk i. An event recorded after each kernel (``record_ready``)
    is what the fetch leg waits on.
    """

    def __init__(self, *args, device: "str | torch.device" = "cuda", **kwargs):
        super().__init__(*args, device=device, **kwargs)
        if self.device.type != "cuda":
            raise ValueError(f"CudaCodec runs on a CUDA device, not {self.device}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CudaCodec: no CUDA device (pass device='cpu' for the plain "
                "PyTorch version)")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._h2d = torch.cuda.Stream(self.device)
        self._compute = torch.cuda.Stream(self.device)
        self._d2h = torch.cuda.Stream(self.device)

    def device_put(self, data: np.ndarray) -> torch.Tensor:
        """Stage host bytes on the device: a pinned copy, then an async copy
        on the H2D stream that the compute stream waits for."""
        host = torch.from_numpy(_writable(data)).pin_memory()
        with torch.cuda.stream(self._h2d):
            dev = host.to(self.device, non_blocking=True)
        self._compute.wait_stream(self._h2d)
        dev.record_stream(self._compute)  # allocated on H2D, read on compute
        return dev

    def device_memory_free(self) -> int:
        """Free device bytes (a snapshot: the card may be shared)."""
        return torch.cuda.mem_get_info(self.device)[0]

    def matmul_device(self, matrix: np.ndarray, data_dev: torch.Tensor,
                      out: "torch.Tensor | None" = None,
                      accumulate: bool = False) -> torch.Tensor:
        """Device-resident matmul: ``data_dev`` (k, N) already on the device;
        returns (R, N) there (XORed into ``out`` with ``accumulate``). Widths
        beyond ``chunk_bytes`` are split into chunk-sized launches that write
        column slices of one output, so each launch stays bounded whatever N
        is (codec.py:414-422 in the JAX package).

        The kernels run on the codec's compute stream, ordered after the
        caller's current stream, and the caller's stream is ordered after
        them: the result is ready for the caller as any PyTorch op's is."""
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        R, n = matrix.shape[0], data_dev.shape[1]
        caller = torch.cuda.current_stream(self.device)
        self._compute.wait_stream(caller)
        with torch.cuda.stream(self._compute):
            if out is None:
                out = torch.empty((R, n), dtype=torch.uint8, device=self.device)
            for pos in range(0, n, self.chunk_bytes):
                end = min(pos + self.chunk_bytes, n)
                gf_matmul(matrix, data_dev[:, pos:end], out=out[:, pos:end],
                          accumulate=accumulate)
        # the allocator must not hand either buffer to another stream while
        # these kernels still use it
        data_dev.record_stream(self._compute)
        out.record_stream(self._compute)
        caller.wait_stream(self._compute)
        return out

    def record_ready(self) -> torch.cuda.Event:
        """An event after the kernels enqueued so far."""
        ev = torch.cuda.Event()
        ev.record(self._compute)
        return ev

    def host_buffer(self, nbytes: int) -> torch.Tensor:
        """A flat pinned uint8 host buffer that device→host copies can land
        in asynchronously. Callers reuse it for results of any shape up to
        ``nbytes`` through ``to_host``."""
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def to_host(self, dev: torch.Tensor, ready: torch.cuda.Event,
                buf: torch.Tensor) -> np.ndarray:
        """Blocking fetch of the (R, N) device result ``dev`` into the flat
        host buffer ``buf``, after the event ``ready``; returns the bytes as
        an (R, N) numpy view of ``buf``. Safe to call from another thread
        than the one that launched the kernel."""
        R, n = dev.shape
        out = buf[: R * n].view(R, n)
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(ready)
            dev.record_stream(self._d2h)
            out.copy_(dev, non_blocking=True)
        self._d2h.synchronize()
        return out.numpy()


class CpuCodec(_TorchCodec):
    """The same device API on CPU tensors, where ``gf_matmul`` takes its
    plain PyTorch version: the reference the tests hold the port to. Only
    an explicit ``device="cpu"`` selects it."""

    def __init__(self, *args, device: "str | torch.device" = "cpu", **kwargs):
        super().__init__(*args, device=device, **kwargs)
        if self.device.type != "cpu":
            raise ValueError(f"CpuCodec runs on the CPU, not {self.device}")

    def device_put(self, data: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(_writable(data))

    def device_memory_free(self) -> None:
        """None: the encoder keeps the requested chunk."""
        return None

    def matmul_device(self, matrix: np.ndarray, data_dev: torch.Tensor,
                      out: "torch.Tensor | None" = None,
                      accumulate: bool = False) -> torch.Tensor:
        return gf_matmul(np.ascontiguousarray(matrix, dtype=np.uint8), data_dev, out=out,
                         accumulate=accumulate)

    def record_ready(self) -> None:
        return None

    def host_buffer(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8)

    def to_host(self, dev: torch.Tensor, ready: None, buf: torch.Tensor) -> np.ndarray:
        R, n = dev.shape
        out = buf[: R * n].view(R, n)
        out.copy_(dev)
        return out.numpy()


def _codec_class(device: "str | torch.device") -> type:
    if device == "mesh":
        from .sharded import MeshCodec  # deferred: sharded imports this module

        return MeshCodec
    kind = torch.device(device).type
    if kind == "cuda":
        return CudaCodec
    if kind == "cpu":
        return CpuCodec
    raise ValueError(f"the port's codec runs on cuda, cpu or mesh, not {device}")


def get_codec(
    data_shards: int = DATA_SHARDS,
    parity_shards: int = PARITY_SHARDS,
    device: "str | torch.device" = "cuda",
    **kwargs,
) -> Codec:
    """Codec factory. Runs on the GPU; raises RuntimeError when there is
    none. Only an explicit ``device="cpu"`` selects the plain PyTorch
    version. ``device="mesh"`` runs over every local CUDA device
    (``sharded.MeshCodec``; ``kwargs`` may name ``tp``, ``devices`` or a
    ``mesh``)."""
    return _codec_class(device)(data_shards, parity_shards, device=device, **kwargs)
