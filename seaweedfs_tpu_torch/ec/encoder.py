"""File-level EC encode/rebuild: .dat → .ec00‥.ec13 (+ .ecx/.ecj/.vif).

Semantics mirror `weed/storage/erasure_coding/ec_encoder.go`:

- the volume's .dat is striped row-major into k data shards: rows of k×1GB
  "large blocks" while more than one full large row remains, then rows of
  k×1MB "small blocks" (zero-padded past EOF) for the tail
  (encodeDatFile, ec_encoder.go:194-231);
- shard i's bytes for a row are dat[row_start + i*block : +block];
- parity shards are the GF(2^8) matmul of the k data blocks;
- every shard file is therefore n_large×large + n_small_rows×small bytes.

Unlike the reference's fixed 256KB buffers, IO is batched in large
column-chunks, each fed to the GPU kernel as one matmul_device call. Output
bytes are identical — the striping layout is a pure function of the .dat
contents.
"""

from __future__ import annotations

import json
import os
import queue
from typing import Optional

import numpy as np

from ..stats import trace as _trace
from ..storage import idx as idx_mod
from ..storage.types import OFFSET_SIZE, TOMBSTONE_FILE_SIZE
from ..util import faultpoints
from .codec import Codec, get_codec
from .constants import (
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    shard_ext,
)

# Host result buffers per pipeline: one being filled by the fetch leg, one
# waiting in the write queue, one being written — _overlap_pipeline's queues
# never hold more fetched chunks than that.
FETCH_RING_DEPTH = 3

# the span of each stage of _overlap_pipeline
_LEG_SPANS = {"read": "ec.read", "compute": "ec.h2d", "fetch": "ec.d2h", "write": "ec.write"}


def _is_hole(fd: int, start: int, length: int) -> bool:
    """True if [start, start+length) is entirely a filesystem hole.

    SEEK_DATA turns sparse sealed volumes (preallocated space, punched
    deletes) from gigabytes of kernel zero-fill reads into a single lseek;
    filesystems without the op just report everything as data."""
    import errno

    # preserve the fd offset: callers may be buffered file objects whose
    # tell() bookkeeping is built on the raw fd position
    cur = os.lseek(fd, 0, os.SEEK_CUR)
    try:
        data_off = os.lseek(fd, start, os.SEEK_DATA)
    except OSError as e:
        return e.errno == errno.ENXIO  # no data at/after start == all hole
    except (AttributeError, ValueError):
        return False
    finally:
        os.lseek(fd, cur, os.SEEK_SET)
    return data_off >= start + length


def _read_block_columns(
    f, start: int, block_size: int, col_off: int, width: int, k: int, dat_size: int
) -> tuple[np.ndarray, bool]:
    """((k, width) matrix, has_data): column slice [col_off, col_off+width)
    of each of the k consecutive block segments starting at ``start``;
    zero-padded past EOF. Hole segments stay zeros without being read;
    has_data=False means every segment was a hole (or past EOF), so callers
    can skip the encode outright."""
    out = np.zeros((k, width), dtype=np.uint8)
    fd = f.fileno()
    has_data = False
    for i in range(k):
        seg_start = start + i * block_size + col_off
        if seg_start >= dat_size:
            continue
        n = min(width, dat_size - seg_start)
        if _is_hole(fd, seg_start, n):
            continue
        f.seek(seg_start)
        buf = f.read(n)
        out[i, : len(buf)] = np.frombuffer(buf, dtype=np.uint8)
        has_data = True
    return out, has_data


def _work_items(
    dat_size: int, k: int, large_block_size: int, small_block_size: int, chunk: int
):
    """Work list covering the .dat in shard-file append order
    (encodeDatFile's large-then-small row walk). Two item kinds:

    - ``("cols", row_start, block_size, col, width)`` — one column slice of
      a row whose blocks exceed the chunk budget (the 1 GB large rows);
    - ``("rows", region_start, block_size, n_rows)`` — n_rows CONSECUTIVE
      rows batched into one device launch. Striping is row-major, so the
      region is a plain ``(n_rows, k, block)`` reshape: per-item width grows
      from one small block (1 MB) to the full chunk (32 MB), turning 10×
      strided 1 MB seeks per item into one sequential read and cutting
      launches + D2H transfers by chunk/block. Output bytes are
      unchanged — batching is associativity of column-independent encode.
    """
    items = []
    remaining, processed = dat_size, 0
    n_large = 0
    while remaining > large_block_size * k:
        n_large += 1
        remaining -= large_block_size * k
    for _ in range(n_large):
        if large_block_size > chunk:
            for col in range(0, large_block_size, chunk):
                items.append(
                    ("cols", processed, large_block_size, col,
                     min(chunk, large_block_size - col))
                )
        else:
            items.append(("rows", processed, large_block_size, 1))
        processed += large_block_size * k
    n_small = 0
    while remaining > 0:
        n_small += 1
        remaining -= small_block_size * k
    if chunk < small_block_size:
        # budget below one block (scarce device memory): column slices per row keep
        # every launch within the budget, as the pre-batching code did
        for r in range(n_small):
            base = processed + r * small_block_size * k
            for col in range(0, small_block_size, chunk):
                items.append(
                    ("cols", base, small_block_size, col,
                     min(chunk, small_block_size - col))
                )
        return items
    rows_per = chunk // small_block_size
    r = 0
    while r < n_small:
        g = min(rows_per, n_small - r)
        items.append(
            ("rows", processed + r * small_block_size * k, small_block_size, g)
        )
        r += g
    return items


def _item_width(item) -> int:
    """Columns this work item contributes to every shard file."""
    if item[0] == "cols":
        return item[4]
    return item[2] * item[3]  # block_size * n_rows


def _region_fully_data(fd: int, start: int, length: int) -> bool:
    """True when [start, start+length) contains no filesystem hole."""
    cur = os.lseek(fd, 0, os.SEEK_CUR)
    try:
        hole_off = os.lseek(fd, start, os.SEEK_HOLE)
    except (OSError, AttributeError, ValueError):
        return True  # no SEEK_HOLE support: everything reads as data
    finally:
        os.lseek(fd, cur, os.SEEK_SET)
    return hole_off >= start + length


def _read_item(f, item, k: int, dat_size: int) -> tuple[np.ndarray, bool]:
    """((k, width) matrix, has_data) for either item kind."""
    if item[0] == "cols":
        _, start, block_size, col, width = item
        return _read_block_columns(f, start, block_size, col, width, k, dat_size)
    _, start, block_size, g = item
    total = g * k * block_size
    end = min(start + total, dat_size)
    if start >= dat_size or _is_hole(f.fileno(), start, end - start):
        return np.zeros((k, g * block_size), dtype=np.uint8), False
    arr = np.zeros(total, dtype=np.uint8)
    if _region_fully_data(f.fileno(), start, end - start):
        # dense region (the common case): ONE sequential read
        f.seek(start)
        buf = f.read(end - start)
        arr[: len(buf)] = np.frombuffer(buf, dtype=np.uint8)
    else:
        # mixed data/holes (punched deletes in sealed volumes): per-block
        # SEEK_DATA skips keep the kernel from zero-filling the holes
        fd = f.fileno()
        for seg in range(g * k):
            seg_start = start + seg * block_size
            if seg_start >= dat_size:
                break
            n = min(block_size, dat_size - seg_start)
            if _is_hole(fd, seg_start, n):
                continue
            f.seek(seg_start)
            buf = f.read(n)
            arr[seg * block_size : seg * block_size + len(buf)] = (
                np.frombuffer(buf, dtype=np.uint8)
            )
    mat = (
        arr.reshape(g, k, block_size)
        .transpose(1, 0, 2)
        .reshape(k, g * block_size)
    )
    return np.ascontiguousarray(mat), True


def _depth_chunk(chunk: int, total_width: int, floor: int, depth: int = 8) -> int:
    """Shrink the per-item column width so the overlap pipeline gets ~depth
    items: a 128 MB volume under the default 32 MB chunk collapses to ONE
    work item, and a single item overlaps nothing (wall = read + H2D +
    kernel + D2H, serial). Rounds up to `floor` (the alignment/batching granularity) and
    never grows past the budgeted `chunk`; big volumes (total/depth ≥
    chunk) are unaffected."""
    target = -(-total_width // depth)
    target = max(floor, -(-target // floor) * floor)
    return max(min(chunk, target), min(chunk, floor))


def _budgeted_chunk(codec, chunk: int, device_streams: int) -> int:
    """Cap the column-chunk size against free device memory.

    The overlap pipeline keeps ≤3 chunks device-resident (one in compute,
    one in the fetch queue, one mid-fetch), each holding
    ~device_streams×chunk bytes of device memory (k input rows staged +
    output rows produced). The card may be shared, so only a quarter of the
    reported free pool is budgeted; oversized chunks are split rather than
    dying out of memory. Codecs without allocator stats (CPU) keep the requested chunk."""
    free = getattr(codec, "device_memory_free", lambda: None)()
    if free is None:  # no allocator stats (CPU codecs): keep the request
        return chunk
    cap = free // (4 * 3 * max(1, device_streams))
    align = codec.alignment() if hasattr(codec, "alignment") else 1
    cap = max(align, (cap // align) * align)
    return min(chunk, cap)


def plan_encode(
    codec,
    dat_size: int,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    chunk_bytes: Optional[int] = None,
) -> tuple[int, list]:
    """The encode work plan — one source of truth for write_ec_files AND
    for callers that must know the plan up front (a benchmark that warms
    the exact chunk widths its timed run will launch).

    Returns ``(chunk, items)``. An explicit ``chunk_bytes`` fixes the
    pipeline depth (no _depth_chunk re-split) but is still capped against
    free device memory — the caller owns the plan's shape, not its memory safety
    (rebuild_ec_files applies the same cap to explicit chunks)."""
    k = codec.data_shards
    chunk = (
        chunk_bytes if chunk_bytes is not None
        else getattr(codec, "chunk_bytes", 8 * 1024 * 1024)
    )
    chunk = _budgeted_chunk(codec, chunk, k + codec.parity_shards)
    if (
        chunk_bytes is None
        and hasattr(codec, "matmul_device")
        and chunk >= small_block_size
    ):
        chunk = _depth_chunk(chunk, -(-dat_size // k), small_block_size)
    items = _work_items(dat_size, k, large_block_size, small_block_size, chunk)
    return chunk, items


def write_ec_files(
    base_file_name: str,
    codec: Optional[Codec] = None,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
    chunk_bytes: Optional[int] = None,
    pipeline_stats: Optional[dict] = None,
    suffix: str = "",
) -> None:
    """Generate all shard files from ``base.dat`` (WriteEcFiles, :57).

    ``suffix`` — appended to every shard file name. The crash-safe commit
    path (storage.store.ec_encode_volume) passes ``".tmp"`` so the shard set
    is staged and only appears under its final names after the commit
    manifest is durable; the bare call writes final names directly.

    Runs a 4-leg overlap pipeline: a reader thread streams column chunks
    off disk, the main thread stages them on the device and launches the
    encode kernel, a fetch thread copies each chunk's parity back into a
    pinned host buffer (the D2H leg), and a writer thread appends the 14
    shard files. Disk read, H2D copy, compute, D2H and file writes for
    neighbouring chunks overlap — the reference's serial 256KB
    read→Encode→write loop (`ec_encoder.go:162-192`) turned into a pipeline.
    """
    codec = codec or get_codec()
    k, m = codec.data_shards, codec.parity_shards
    dat = base_file_name + ".dat"
    dat_size = os.path.getsize(dat)
    _, items = plan_encode(
        codec, dat_size, large_block_size, small_block_size, chunk_bytes
    )

    outputs = [
        open(base_file_name + shard_ext(i) + suffix, "wb")
        for i in range(k + m)
    ]
    try:
        _encode_pipelined(dat, items, codec, outputs, dat_size,
                          stats=pipeline_stats)
        final = ec_shard_base_size(dat_size, k, large_block_size,
                                   small_block_size)
        for o in outputs:
            o.truncate(final)
    finally:
        for o in outputs:
            o.close()


def _overlap_pipeline(produce, compute, consume, fetch,
                      stats: Optional[dict] = None, release=None,
                      nbytes=None) -> None:
    """Four-stage overlap shared by encode and rebuild: a reader thread
    runs `produce` (an iterator of host chunks), the main thread runs
    `compute` (H2D copy + kernel launch, both asynchronous), a fetch thread
    runs `fetch` (blocks on device results — the D2H leg), and a writer
    thread runs `consume` (writes files). Bounded queues give ~2 chunks of
    lookahead per edge; any stage failing drains the others so every
    thread exits and the first error is re-raised. `release` is called on
    every fetched chunk that the writer drops unconsumed after a failure,
    so the fetch leg's buffers go back to their ring.

    Each call of a stage callable is one span (``stats/trace.py``) on its
    thread, parented on the caller's span: ``ec.read`` (produce), ``ec.h2d``
    (compute), ``ec.d2h`` (fetch) and ``ec.write`` (consume), tagged with
    the ``bytes`` that ``nbytes(stage, got, out)`` gives for the call's
    argument and result (``got`` is None for produce). With a ``stats``
    dict, per-stage BUSY time (the sum of the stage's span times: time
    inside the stage callable, excluding queue blocking) and wall time are
    recorded, plus ``efficiency`` = max(stage busy) / wall — 1.0 means the
    slowest stage fully hides the others, i.e. wall ≈ max(stage) rather
    than Σ(stages)."""
    import contextvars
    import threading
    import time as _time

    # one-slot mid/out queues: enough lookahead for compute(i+1) to ride
    # the link concurrently with fetch(i), without tripling the chunks of
    # host+device memory the pipeline keeps resident
    read_q: queue.Queue = queue.Queue(maxsize=2)
    fetch_q: queue.Queue = queue.Queue(maxsize=1)
    write_q: queue.Queue = queue.Queue(maxsize=1)
    errors: list[BaseException] = []
    busy = {"read": 0.0, "compute": 0.0, "fetch": 0.0, "write": 0.0}
    t_wall = _time.perf_counter()

    def leg(stage: str, fn, got=None):
        """One call of a stage callable, timed once: its span's stamps
        give the stage's busy time."""
        scope = _trace.start_span(_LEG_SPANS[stage], service="ec")
        with scope:
            out = fn() if got is None else fn(got)
            if nbytes is not None:
                scope.tag(bytes=nbytes(stage, got, out))
        busy[stage] += scope.seconds
        return out

    def reader():
        try:
            it = produce()
            while True:
                item = leg("read", lambda: next(it, None))
                if item is None or errors:
                    return
                read_q.put(item)
        except BaseException as e:  # surfaced after join
            errors.append(e)
        finally:
            read_q.put(None)

    def fetcher():
        try:
            while True:
                got = fetch_q.get()
                if got is None:
                    return
                write_q.put(leg("fetch", fetch, got))
        except BaseException as e:
            errors.append(e)
            while fetch_q.get() is not None:  # drain so the feeder unblocks
                pass
        finally:
            write_q.put(None)

    def writer():
        try:
            while True:
                got = write_q.get()
                if got is None:
                    return
                leg("write", consume, got)
        except BaseException as e:
            errors.append(e)
            while True:  # drain so the fetcher unblocks
                got = write_q.get()
                if got is None:
                    return
                if release is not None:
                    release(got)

    # each leg thread runs in a copy of the caller's context, so its spans
    # join the caller's trace
    rt, wt, ft = (threading.Thread(target=contextvars.copy_context().run, args=(f,),
                                   daemon=True) for f in (reader, writer, fetcher))
    rt.start()
    wt.start()
    ft.start()
    try:
        while True:
            got = read_q.get()
            if got is None:
                break
            if errors:
                continue  # keep draining so the reader can finish
            try:
                fetch_q.put(leg("compute", compute, got))
            except BaseException as e:
                errors.append(e)
    finally:
        fetch_q.put(None)
        ft.join()  # fetcher forwards its None to write_q on exit
        wt.join()
        # unblock the reader if it is mid-put (main loop exited early)
        while rt.is_alive():
            try:
                read_q.get_nowait()
            except queue.Empty:
                rt.join(timeout=0.05)
        rt.join()
    if errors:
        raise errors[0]
    if stats is not None:
        wall = _time.perf_counter() - t_wall
        stats.update(
            wall_s=wall,
            read_busy_s=busy["read"],
            compute_busy_s=busy["compute"],
            fetch_busy_s=busy["fetch"],
            write_busy_s=busy["write"],
            efficiency=max(busy.values()) / wall if wall > 0 else 0.0,
        )


def _fetch_ring(codec, rows: int, widest: int, n_items: int) -> queue.Queue:
    """Host buffers for the D2H leg, reused round-robin: a buffer goes back
    on the queue only after the writer is done with it, so no fetch can
    overwrite bytes that are still being written."""
    ring: queue.Queue = queue.Queue()
    for _ in range(min(FETCH_RING_DEPTH, n_items)):
        ring.put(codec.host_buffer(rows * widest))
    return ring


def _encode_pipelined(dat, items, codec, outputs, dat_size: int,
                      stats: Optional[dict] = None) -> None:
    k, m = codec.data_shards, codec.parity_shards
    ring = _fetch_ring(codec, m, max(map(_item_width, items), default=0), len(items))

    def produce():
        with open(dat, "rb") as f:
            for it in items:
                data, has_data = _read_item(f, it, k, dat_size)
                yield (_item_width(it), data, has_data)

    def compute(got):
        width, data, has_data = got
        if not has_data or not data.any():
            return width, data, None, None  # zero chunk: parity is zeros, skip device
        parity_dev = codec.matmul_device(codec.parity_rows, codec.device_put(data))
        return width, data, parity_dev, codec.record_ready()

    def fetch(got):
        width, data, parity_dev, ready = got
        if parity_dev is None:
            return width, data, None, None
        buf = ring.get()
        return width, data, codec.to_host(parity_dev, ready, buf), buf

    def release(got):
        if got[3] is not None:
            ring.put(got[3])

    def nbytes(stage, got, out):
        if stage == "read":
            return 0 if out is None else out[1].nbytes
        if stage == "compute":
            return 0 if out[2] is None else got[1].nbytes
        return 0 if got[2] is None else (m if stage == "fetch" else k + m) * got[0]

    def consume(got):
        try:
            faultpoints.fire("ec.encode.chunk", path=outputs[0].name)
            width, data, parity, _ = got
            if parity is None:
                for o in outputs:  # keep sparse regions sparse (holes)
                    o.seek(width, 1)
                return
            for i in range(k):
                outputs[i].write(data[i, :width].tobytes())
            for j in range(m):
                outputs[k + j].write(parity[j, :width].tobytes())
        finally:
            release(got)

    _overlap_pipeline(produce, compute, consume, fetch, stats=stats,
                      release=release, nbytes=nbytes)


def rebuild_ec_files(
    base_file_name: str,
    codec: Optional[Codec] = None,
    chunk_bytes: Optional[int] = None,
    pipeline_stats: Optional[dict] = None,
) -> list[int]:
    """Regenerate missing shard files from ≥k present ones
    (RebuildEcFiles / generateMissingEcFiles, :61,95). Returns generated ids."""
    codec = codec or get_codec()
    total = codec.total_shards
    chunk = (
        chunk_bytes if chunk_bytes is not None
        else getattr(codec, "chunk_bytes", 8 * 1024 * 1024)
    )
    chunk = _budgeted_chunk(codec, chunk, total)

    present: dict[int, str] = {}
    missing: list[int] = []
    for sid in range(total):
        path = base_file_name + shard_ext(sid)
        if os.path.exists(path):
            present[sid] = path
        else:
            missing.append(sid)
    if not missing:
        return []
    if len(present) < codec.data_shards:
        raise ValueError(
            f"need {codec.data_shards} shards to rebuild, have {len(present)}"
        )

    sizes = {os.path.getsize(p) for p in present.values()}
    if len(sizes) != 1:
        raise ValueError(f"ec shard sizes disagree: {sizes}")
    shard_size = sizes.pop()

    ins = {sid: open(p, "rb") for sid, p in present.items()}
    outs = {sid: open(base_file_name + shard_ext(sid), "wb") for sid in missing}
    try:
        _rebuild_pipelined(
            codec, ins, outs, missing, shard_size,
            _depth_chunk(chunk, shard_size, codec.alignment()),
            stats=pipeline_stats,
        )
        for sid in missing:
            outs[sid].truncate(shard_size)
    finally:
        for fh in ins.values():
            fh.close()
        for fh in outs.values():
            fh.close()
    return missing


def _rebuild_rows(codec, present_ids: list[int], missing: list[int]) -> np.ndarray:
    """One matrix rebuilding every missing shard from the first k present
    shards. Missing data shards take their decode-matrix rows; missing
    parity rows compose through the full decode matrix
    (matrix[mp] · decode = parity-of-reconstructed-data), so a single
    matmul per chunk covers both — bit-identical to the two-step
    Codec.reconstruct, which tests assert."""
    from . import gf

    k = codec.data_shards
    first_k = present_ids[:k]
    decode_full = codec._decode_matrix_for(first_k)
    missing_data = [i for i in missing if i < k]
    missing_parity = [i for i in missing if i >= k]
    blocks = []
    if missing_data:
        blocks.append(decode_full[missing_data])
    if missing_parity:
        blocks.append(gf.mat_mul(codec.matrix[missing_parity], decode_full))
    # missing is sorted and data ids < parity ids, so this stacking order
    # matches the outs iteration order
    return np.vstack(blocks)


def _rebuild_pipelined(codec, ins, outs, missing, shard_size, chunk,
                       stats: Optional[dict] = None) -> None:
    """Overlap disk reads, H2D staging + device matmul, the D2H fetch and
    shard writes — the encode pipeline's shape applied to rebuild (the
    serial read→reconstruct→write loop leaves the device idle during IO)."""
    k = codec.data_shards
    present_ids = sorted(ins)
    first_k = present_ids[:k]
    rows = _rebuild_rows(codec, present_ids, missing)
    n_chunks = -(-shard_size // chunk)
    ring = _fetch_ring(codec, len(missing), min(chunk, shard_size), n_chunks)

    def produce():
        pos = 0
        while pos < shard_size:
            width = min(chunk, shard_size - pos)
            buf = np.zeros((k, width), dtype=np.uint8)
            has_data = False
            for row, sid in enumerate(first_k):
                if _is_hole(ins[sid].fileno(), pos, width):
                    continue
                ins[sid].seek(pos)
                buf[row, :width] = np.frombuffer(
                    ins[sid].read(width), dtype=np.uint8
                )
                has_data = True
            yield (width, buf, has_data)
            pos += width

    def compute(got):
        width, buf, has_data = got
        if not has_data or not buf.any():
            return width, None, None  # zeros reconstruct to zeros
        out_dev = codec.matmul_device(rows, codec.device_put(buf))
        return width, out_dev, codec.record_ready()

    def fetch(got):
        width, out_dev, ready = got
        if out_dev is None:
            return width, None, None
        buf = ring.get()
        return width, codec.to_host(out_dev, ready, buf), buf

    def release(got):
        if got[2] is not None:
            ring.put(got[2])

    def nbytes(stage, got, out):
        if stage == "read":
            return 0 if out is None else out[1].nbytes
        if stage == "compute":
            return 0 if out[1] is None else got[1].nbytes
        return 0 if got[1] is None else len(missing) * got[0]

    def consume(got):
        try:
            width, out, _ = got
            if out is None:
                for sid in missing:
                    outs[sid].seek(width, 1)
                return
            for j, sid in enumerate(missing):
                outs[sid].write(out[j, :width].tobytes())
        finally:
            release(got)

    _overlap_pipeline(produce, compute, consume, fetch, stats=stats,
                      release=release, nbytes=nbytes)


# -- .ecx sorted index -------------------------------------------------------
def write_sorted_file_from_idx(
    base_file_name: str, ext: str = ".ecx", offset_size: int = OFFSET_SIZE
) -> None:
    """.idx → ascending-key sorted .ecx (WriteSortedFileFromIdx, :27-55).

    Replays the append-ordered .idx with latest-wins semantics (deletes drop
    the key), then writes entries in ascending key order.
    """
    entries: dict[int, tuple[int, int]] = {}
    with open(base_file_name + ".idx", "rb") as f:
        for key, offset, size in idx_mod.iter_index_file(f, offset_size):
            if offset != 0 and size != TOMBSTONE_FILE_SIZE:
                entries[key] = (offset, size)
            else:
                entries.pop(key, None)
    with open(base_file_name + ext, "wb") as out:
        for key in sorted(entries):
            offset, size = entries[key]
            out.write(idx_mod.pack_entry(key, offset, size, offset_size))


# -- .vif volume info --------------------------------------------------------
def save_volume_info(
    file_name: str,
    version: int = 3,
    replication: str = "",
    shard_sums: "list[str] | None" = None,
) -> None:
    """jsonpb-style VolumeInfo (pb/volume_info.go:56 SaveVolumeInfo).

    ``shard_sums`` (sha256 hex per shard id, written at encode time) gives
    the background scrub a ground truth for shard integrity: RS encoding is
    deterministic, so a rebuilt shard hashes identically and the sums stay
    valid across rebuilds and copies (the .vif travels with the shards)."""
    info = {"files": [], "version": version, "replication": replication}
    if shard_sums is not None:
        info["shard_sums"] = shard_sums
    with open(file_name, "w") as f:
        f.write(json.dumps(info, indent=2))


def load_volume_info(file_name: str) -> dict:
    if not os.path.exists(file_name):
        return {"files": [], "version": 0, "replication": ""}
    with open(file_name) as f:
        return json.load(f)


def ec_shard_base_size(
    dat_size: int,
    data_shards: int,
    large_block_size: int = LARGE_BLOCK_SIZE,
    small_block_size: int = SMALL_BLOCK_SIZE,
) -> int:
    """Size every shard file will have for a given .dat size."""
    k = data_shards
    n_large = 0
    remaining = dat_size
    while remaining > large_block_size * k:
        n_large += 1
        remaining -= large_block_size * k
    n_small = 0
    while remaining > 0:
        n_small += 1
        remaining -= small_block_size * k
    return n_large * large_block_size + n_small * small_block_size
