"""Multi-device EC encode over a (dp, sp, tp) mesh of torch devices.

The counterpart of the JAX package's ``ec/sharded.py``. How RS encode
spreads over devices, in the vocabulary of ML parallelism:

- **dp** (batch): independent volumes or row batches encode on different
  devices; the only axis that may cross a process (``make_sharded_encode``
  with ``process_local=True``);
- **sp** (sequence): one volume's byte columns split across devices. Parity
  is columnwise, so the column slices need no communication;
- **tp** (tensor): the GF(2) contraction over the ``8k`` bit rows (index
  ``d * 8 + bit``) split across devices. Each tp rank runs the hand-written
  kernel on its data masked to its bit slice, and the partial byte results
  are XORed together. The reference sums partial bit counts with an int32
  ``psum`` and keeps the low bit; XOR is that sum mod 2, so the bytes are
  the same.

Every device runs ``gf_matmul`` on its slice: the kernel on CUDA tensors,
the plain version on CPU tensors, by the wrapper's own routing. A mesh may
repeat a device (``[cuda:0] * 4``, ``[cpu] * 8``), which exercises every
split on one card, as the JAX tests use XLA's virtual host devices.

``MeshCodec``'s mesh is process-local. Only ``make_sharded_encode(...,
process_local=True)`` spans ``torch.distributed`` ranks, along dp: each
rank passes and gets back its own dp rows, and the caller gathers them
(``dist.all_gather``), where the reference's global array would.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from .codec import CpuCodec, CudaCodec, _TorchCodec, _writable
from .constants import DATA_SHARDS, PARITY_SHARDS

AXES = ("dp", "sp", "tp")
# column slices start on this many bytes, so that each device's slice keeps
# the kernel's 16-byte vector path when the whole row does
COLUMN_ALIGN = 32


def factor_mesh(n_devices: int, tp: int = 1) -> tuple[int, int, int]:
    """Split n into (dp, sp, tp) axis sizes, preferring balance.

    tp defaults to 1: the RS contraction dim is tiny (80 bits for RS(10,4)),
    so splitting it buys nothing and costs a combine per chunk, while dp/sp
    shard columns with NO communication and let each device run the kernel
    at its full single-device rate. tp>1 stays supported for callers that
    want the contraction split."""
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide n_devices={n_devices}")
    dp = sp = 1
    n = n_devices // tp
    while n % 2 == 0:
        if dp <= sp:
            dp *= 2
        else:
            sp *= 2
        n //= 2
    dp *= n  # odd remainder onto dp
    return dp, sp, tp


def _device(d: "str | torch.device") -> torch.device:
    """A device with its index: ``cuda`` is the current CUDA device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (dp, sp, tp) array of ``torch.device``s with the axis names.

    ``processes`` holds, per position, the ``torch.distributed`` rank whose
    device it is; None means every device belongs to this process."""

    def __init__(self, devices: np.ndarray, processes: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(AXES):
            raise ValueError(f"want a {AXES} device array, got shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXES
        if processes is not None:
            processes = np.asarray(processes, dtype=np.int64)
            if processes.shape != devices.shape:
                raise ValueError("processes must have the devices' shape")
        self.processes = processes

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def build_mesh(n_devices: Optional[int] = None, tp: int = 1,
               devices: Optional[Sequence["str | torch.device"]] = None) -> Mesh:
    """A process-local mesh over ``devices`` (default: every local CUDA
    device). Raises when fewer devices exist than asked for; never falls
    to the CPU. An explicit ``devices`` list may repeat a device."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else n_devices
        if have == 0 or want > have:
            raise RuntimeError(f"build_mesh: {want or 1} CUDA device(s) asked for, "
                               f"{have} present (pass devices=[...] for an explicit mesh)")
        devices = [torch.device("cuda", i) for i in range(want)]
    else:
        devices = [_device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    shape = factor_mesh(len(devices), tp)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape))


def build_process_mesh(local_devices: Sequence["str | torch.device"], tp: int = 1) -> Mesh:
    """A mesh over every rank's ``local_devices`` (the same list on each),
    ordered by rank as ``jax.devices()`` is after ``jax.distributed``:
    rank r's devices are positions ``r * L ... (r + 1) * L - 1``. Needs the
    default process group (``init_mesh``)."""
    import torch.distributed as dist

    world_size = dist.get_world_size()
    local = [_device(d) for d in local_devices]
    n = world_size * len(local)
    shape = factor_mesh(n, tp)
    devs = np.empty(n, dtype=object)
    devs[:] = local * world_size
    procs = np.repeat(np.arange(world_size), len(local))
    return Mesh(devs.reshape(shape), procs.reshape(shape))


def init_mesh(coordinator: str, world_size: int, rank: int, backend: str,
              timeout: float = 60.0) -> None:
    """Join the default ``torch.distributed`` process group at
    ``tcp://<coordinator>`` (rank 0 serves the rendezvous there). The
    backend is explicit: ``nccl`` for CUDA ranks, ``gloo`` for CPU ranks
    (and for ranks that share one card, which NCCL refuses). ``timeout``
    bounds the rendezvous and every collective, in seconds."""
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want nccl or gloo")
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


class MeshArray:
    """(rows, n) bytes on a mesh as blocks: per device, one tensor for each
    run of consecutive column shards the device serves, holding that run's
    columns ``[start, start + width)``."""

    def __init__(self, shape: tuple[int, int], blocks: list, where: dict):
        self.shape = tuple(shape)
        self.blocks = blocks  # [(device, start column, tensor)]
        self._where = where  # (column shard, device) -> index into blocks

    def cols(self, shard: int, device: torch.device, c0: int, c1: int) -> torch.Tensor:
        _, start, t = self.blocks[self._where[shard, device]]
        return t[:, c0 - start:c1 - start]


class MeshCodec(_TorchCodec):
    """Codec whose matmul runs over a process-local (dp, sp, tp) mesh.

    Drop-in for the volume server's ``store.ec_codec`` (``-ec.backend
    mesh``): ``write_ec_files``, ``rebuild_ec_files`` and the ``Store``'s
    reconstruction run on it unchanged through the device API the encoder
    calls (``alignment``, ``device_put``, ``matmul_device``,
    ``record_ready``, ``host_buffer``, ``to_host``). Columns split over
    dp x sp; each device runs ``gf_matmul`` on its column slice, a strided
    view when the data is already there. With tp > 1 each tp rank runs the
    kernel on its bit slice of the contraction and the ranks' partial bytes
    XOR together: on the rank-0 device's output by the kernel itself
    (``accumulate``) when the rank shares that device, through a copy and a
    device XOR when it does not.

    Each distinct device gets a ``CudaCodec`` (or ``CpuCodec``) of its own,
    whose streams carry its copies and kernels."""

    def __init__(self, data_shards: int = DATA_SHARDS, parity_shards: int = PARITY_SHARDS,
                 mesh: Optional[Mesh] = None, tp: int = 1,
                 devices: Optional[Sequence] = None,
                 chunk_bytes: int = 32 * 1024 * 1024, matrix: Optional[np.ndarray] = None,
                 device: str = "mesh"):
        if device != "mesh":
            raise ValueError(f"MeshCodec runs on a mesh, not {device}")
        mesh = mesh if mesh is not None else build_mesh(tp=tp, devices=devices)
        if mesh.processes is not None and len(set(mesh.processes.flat)) > 1:
            raise ValueError("MeshCodec's mesh is process-local; a mesh over ranks "
                             "runs through make_sharded_encode(process_local=True)")
        first = mesh.devices.flat[0]
        super().__init__(data_shards, parity_shards, matrix=matrix, device=first,
                         chunk_bytes=chunk_bytes)
        self.mesh = mesh
        dp, sp, tp = mesh.devices.shape
        self._n_col_shards = dp * sp
        self._tp = tp
        # per column shard, its tp devices; rank 0's device holds the output
        self._cols = [list(row) for row in mesh.devices.reshape(dp * sp, tp)]
        self._codecs = {}
        for d in mesh.devices.flat:
            if d not in self._codecs:
                cls = CudaCodec if d.type == "cuda" else CpuCodec
                self._codecs[d] = cls(data_shards, parity_shards, matrix=self.matrix,
                                      device=d, chunk_bytes=chunk_bytes)
        self._plans: dict = {}
        self._masks: dict = {}

    # -- layout --------------------------------------------------------------
    def alignment(self) -> int:
        """Chunk widths are rounded to this: one byte per column shard (the
        kernel masks ragged tails, so any width is served)."""
        return self._n_col_shards

    def _col_ranges(self, n: int) -> list[tuple[int, int]]:
        per = -(-n // self._n_col_shards)
        per = -(-per // COLUMN_ALIGN) * COLUMN_ALIGN
        return [(min(i * per, n), min((i + 1) * per, n)) for i in range(self._n_col_shards)]

    def _spans(self, n: int, outputs: bool) -> list:
        """[(device, c0, c1, column shards)]: the columns each device needs,
        their data (every tp rank) or outputs (rank 0), one span per run of
        consecutive column shards it serves. A device whose shards are not
        consecutive (``[a, b] * 2``) gets a span for each run, so that no
        span covers another device's columns."""
        spans: list = []
        last: dict = {}  # device -> index of its latest span
        for i, ((c0, c1), devs) in enumerate(zip(self._col_ranges(n), self._cols)):
            if c0 >= c1:
                continue
            for d in dict.fromkeys(devs[:1] if outputs else devs):
                j = last.get(d)
                if j is not None and spans[j][3][-1] == i - 1:
                    _, lo, _, shards = spans[j]
                    spans[j] = (d, lo, c1, shards + [i])
                else:
                    last[d] = len(spans)
                    spans.append((d, c0, c1, [i]))
        return spans

    def _mesh_array(self, shape: tuple, outputs: bool, make) -> MeshArray:
        """A MeshArray over ``_spans``, each block ``make(device, c0, c1)``."""
        blocks, where = [], {}
        for d, c0, c1, shards in self._spans(shape[1], outputs):
            for i in shards:
                where[i, d] = len(blocks)
            blocks.append((d, c0, make(d, c0, c1)))
        return MeshArray(shape, blocks, where)

    def _tp_plan(self, matrix: np.ndarray) -> list:
        """Per tp rank: (its columns of the matrix, first data row, end row,
        per-row byte masks or None when every bit of its rows is its own)."""
        key = (matrix.shape, matrix.tobytes())
        plan = self._plans.get(key)
        if plan is None:
            k = matrix.shape[1]
            if (8 * k) % self._tp:
                raise ValueError(f"contraction dim {8 * k} not divisible by tp={self._tp}")
            per = 8 * k // self._tp
            plan = []
            for t in range(self._tp):
                b0, b1 = t * per, (t + 1) * per
                d0, d1 = b0 // 8, -(-b1 // 8)
                rows = np.arange(d0, d1)[:, None] * 8 + np.arange(8)[None, :]
                keep = (rows >= b0) & (rows < b1)
                mask = (keep.astype(np.uint8) << np.arange(8, dtype=np.uint8)).sum(
                    axis=1).astype(np.uint8)
                plan.append((np.ascontiguousarray(matrix[:, d0:d1]), d0, d1,
                             None if (mask == 0xFF).all() else mask))
            self._plans[key] = plan
        return plan

    def _mask_on(self, mask: np.ndarray, device: torch.device) -> torch.Tensor:
        key = (mask.tobytes(), device)
        t = self._masks.get(key)
        if t is None:
            t = self._masks[key] = torch.from_numpy(mask.copy()).to(device)[:, None]
        return t

    def _place(self, data) -> MeshArray:
        """Data as a MeshArray: as is, or a tensor whose columns each device
        views (its own device) or copies (another device)."""
        if isinstance(data, MeshArray):
            return data

        def part(d, c0, c1):
            p = data[:, c0:c1]
            return p if p.device == d else p.to(d)

        return self._mesh_array(tuple(data.shape), False, part)

    # -- the device API of encoder.py ----------------------------------------
    def device_put(self, data: np.ndarray) -> MeshArray:
        """Stage host bytes: each device gets the spans of columns it needs
        through its codec's pinned, asynchronous copy."""
        n = data.shape[1]

        def put(d, c0, c1):
            return self._codecs[d].device_put(
                data if (c0, c1) == (0, n) else _writable(data[:, c0:c1]))

        return self._mesh_array(tuple(data.shape), False, put)

    def device_memory_free(self) -> Optional[int]:
        """The chunk width the tightest device affords: its free bytes over
        its share of the column shards (None on the CPU)."""
        share: dict = {}
        for devs in self._cols:
            for d in devs:
                share[d] = share.get(d, 0) + 1
        free = [self._codecs[d].device_memory_free() for d in share]
        if any(f is None for f in free):
            return None
        return min(f * self._n_col_shards // share[d] for f, d in zip(free, share))

    def matmul_device(self, matrix: np.ndarray, data, out: "torch.Tensor | None" = None):
        """(R x k) @ (k x N) on mesh-resident data: a MeshArray from
        ``device_put``, or a tensor on any device. Returns a MeshArray of
        the (R, N) result, or ``out`` (a tensor) filled with it."""
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        data = self._place(data)
        R, n = matrix.shape[0], data.shape[1]
        if data.shape[0] != matrix.shape[1]:
            raise ValueError(f"shape mismatch {matrix.shape} @ {data.shape}")
        plan = self._tp_plan(matrix)

        def dst(d, c0, c1):
            if out is not None and out.device == d:
                return out[:, c0:c1]
            return torch.empty((R, c1 - c0), dtype=torch.uint8, device=d)

        res = self._mesh_array((R, n), True, dst)
        for i, ((c0, c1), devs) in enumerate(zip(self._col_ranges(n), self._cols)):
            if c0 >= c1:
                continue
            home = devs[0]
            y = res.cols(i, home, c0, c1)
            for t, d in enumerate(devs):
                sub, d0, d1, mask = plan[t]
                x = data.cols(i, d, c0, c1)[d0:d1]
                if mask is not None:
                    x = x & self._mask_on(mask, d)
                codec = self._codecs[d]
                if d == home:
                    codec.matmul_device(sub, x, out=y, accumulate=t > 0)
                    continue
                part = codec.matmul_device(sub, x)
                if d.type == "cuda":
                    part.record_stream(torch.cuda.current_stream(d))
                y.bitwise_xor_(part.to(home))
        if out is None:
            return res
        for d, c0, t in res.blocks:
            if out.device != d:
                out[:, c0:c0 + t.shape[1]].copy_(t)
        return out

    def record_ready(self) -> Optional[dict]:
        """Per CUDA device, an event after the work enqueued so far on its
        current stream (which waits for the codec's kernels)."""
        events = {}
        for d in self._codecs:
            if d.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                events[d] = ev
        return events or None

    def host_buffer(self, nbytes: int) -> torch.Tensor:
        return self._codecs[self.device].host_buffer(nbytes)

    def to_host(self, dev: MeshArray, ready: Optional[dict], buf: torch.Tensor) -> np.ndarray:
        """Blocking fetch of a MeshArray result into the flat host buffer
        ``buf``: each block lands in its columns of the (R, N) view, copied
        on its device's D2H stream after that device's event."""
        R, n = dev.shape
        host = buf[: R * n].view(R, n)
        for d, c0, t in dev.blocks:
            w = t.shape[1]
            dst = host if (c0, w) == (0, n) else host[:, c0:c0 + w]
            if d.type != "cuda":
                dst.copy_(t)
                continue
            stream = self._codecs[d]._d2h
            with torch.cuda.stream(stream):
                if ready and d in ready:
                    stream.wait_event(ready[d])
                t.record_stream(stream)
                dst.copy_(t, non_blocking=dst.is_contiguous())
            stream.synchronize()
        return host.numpy()


def make_sharded_encode(mesh: Mesh, matrix: np.ndarray, process_local: bool = False):
    """Batched encode step over a (dp, sp, tp) mesh.

    ``fn(data: uint8[B, k, N]) -> uint8[B, R, N]`` (``matrix`` is R x k,
    e.g. a codec's ``parity_rows``), with B split over dp, N over sp and
    the bit contraction over tp. ``data`` is a tensor on any device or a
    host array; the result lies on the first device of this process's
    first dp slice.

    With ``process_local=True`` the mesh may span ``torch.distributed``
    ranks (``build_process_mesh``): dp is the only axis that may cross a
    process, and each rank passes and gets back only its own dp slices'
    rows; the caller gathers them (``dist.all_gather``)."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    tp = mesh.shape["tp"]
    if (8 * matrix.shape[1]) % tp:
        raise ValueError(f"contraction dim {8 * matrix.shape[1]} not divisible by tp={tp}")
    dp = mesh.shape["dp"]
    procs = mesh.processes if mesh.processes is not None else np.zeros(
        mesh.devices.shape, dtype=np.int64)
    if process_local:
        # tp/sp must stay within each process: dp is the only axis allowed
        # to cross the process boundary
        for i in range(dp):
            ranks = sorted(set(int(r) for r in procs[i].flat))
            if len(ranks) != 1:
                raise ValueError("process_local=True requires the sp/tp axes to stay "
                                 f"within one process; dp slice {i} spans processes {ranks}")
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        local = [i for i in range(dp) if int(procs[i].flat[0]) == rank]
        if not local:
            raise ValueError(f"rank {rank} holds no dp slice of {mesh}")
    else:
        if len(set(int(r) for r in procs.flat)) > 1:
            raise ValueError("the mesh spans processes: pass process_local=True")
        local = list(range(dp))
    k, R = matrix.shape[1], matrix.shape[0]
    codecs = [MeshCodec(k, max(R, 1), mesh=Mesh(mesh.devices[i:i + 1])) for i in local]
    home = mesh.devices[local[0]].flat[0]

    def encode_step(data):
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(_writable(data))
        if data.dim() != 3 or data.shape[1] != k:
            raise ValueError(f"want uint8[B, {k}, N], got {tuple(data.shape)}")
        B, _, n = data.shape
        if B % len(codecs):
            raise ValueError(f"batch {B} does not split over {len(codecs)} dp slices")
        per = B // len(codecs)
        out = torch.empty((B, R, n), dtype=torch.uint8, device=home)
        for j, codec in enumerate(codecs):
            for b in range(j * per, (j + 1) * per):
                codec.matmul_device(matrix, data[b], out=out[b])
        return out

    return encode_step
