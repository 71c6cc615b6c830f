"""Store: all disk locations of one volume server; routes needle ops.

Mirrors `weed/storage/store.go` + `store_ec.go`: volume CRUD across
DiskLocations, heartbeat messages with delta queues for the master, the
crash-safe EC encode of a sealed volume (VolumeEcShardsGenerate), and the EC
read path with on-the-fly reconstruction (store_ec.go:122-375):

    local shard read → remote shard fetch (``remote_shard_reader``, which
    the volume server wires to its peers) → reconstruction from ≥k sibling
    shards through the EC codec (the GPU kernel, or its plain version).

The EC pieces are module functions (``ec_encode_volume``,
``read_ec_shard_needle``, ``recover_interval``) that take the codec and the
remote reader as arguments; the ``Store`` methods call them with its own.

The EC read path runs under spans (``stats/trace.py``): ``store.ec_read``
for each interval read, ``store.fetch_sibling`` for each remote shard fetch
and ``store.reconstruct`` for each codec reconstruct, each tagged with its
bytes; the seal's shard sums run under ``store.sums`` and its staged commit
under ``store.commit``.

Two departures from the JAX package's read path, in timing and fetch order
only (the bytes are the same for any k survivors): a reader that reports no
holder for a shard (``NoShardHolderError``) gets no further attempt and no
backoff, and ``recover_interval`` reads the local siblings first and fetches
the remote ones it still needs concurrently, as upstream
``recoverOneRemoteEcShardInterval`` does.
"""

from __future__ import annotations

import contextvars
import dataclasses
import hashlib
import itertools
import os
import threading
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Optional

import numpy as np

from ..ec import encoder
from ..ec.codec import Codec, get_codec
from ..ec.constants import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, TOTAL_SHARDS, shard_ext
from ..ec.ec_volume import EcVolume, NeedsShardError
from ..ec.ec_volume import NotFoundError as EcNotFoundError
from ..stats import heat
from ..stats import trace
from ..util import faultpoints, glog
from ..util.locks import make_lock, make_rlock
from ..util.retry import POISON, TRANSIENT, RetryError, RetryPolicy, retry_call
from . import crc
from .commit import StagedCommit
from .disk_location import DiskLocation, parse_volume_base_name
from .needle import Needle
from .replica_placement import ReplicaPlacement
from .ttl import EMPTY_TTL, TTL, read_ttl
from .volume import NotFoundError, Volume

# remote_read(vid, shard_id, offset, size) -> bytes, or None when the
# servers that hold the shard failed; raises NoShardHolderError when none does
RemoteShardReader = Callable[[int, int, int, int], Optional[bytes]]


class NoShardHolderError(LookupError):
    """A remote shard reader's answer that no other server holds the shard:
    a fact of the placement, not a failed attempt, so the read goes straight
    to reconstruction."""


# -- EC functions ------------------------------------------------------------
def ec_encode_volume(base: str, codec: Codec, version: int = 3,
                     replication: str = "000",
                     pipeline_stats: Optional[dict] = None) -> list[int]:
    """Stripe the sealed volume ``base.dat``/``base.idx`` into 14 shards +
    .ecx + .vif with an all-or-nothing commit; the caller has sealed it.

    Every output is written to a ``.tmp`` staging name; files are fsync'd,
    a commit manifest is written atomically, and only then do the staged
    files take their final names (storage/commit.py). A crash anywhere
    leaves the volume fully plain-readable or fully EC-readable. Returns
    the shard ids generated."""
    sc = StagedCommit(base, "ec.encode")
    for sid in range(TOTAL_SHARDS):
        sc.stage(base + shard_ext(sid))
    sc.stage(base + ".ecx")
    vif_tmp = sc.stage(base + ".vif")
    try:
        encoder.write_ec_files(base, codec, suffix=".tmp",
                               pipeline_stats=pipeline_stats)
        encoder.write_sorted_file_from_idx(base, ext=".ecx.tmp")
        # per-shard sha256 into the .vif: the integrity ground truth (RS is
        # deterministic, so rebuilt shards hash identically)
        sums, hashed = [], 0
        with trace.start_span("store.sums", service="store") as span:
            for sid in range(TOTAL_SHARDS):
                digest = hashlib.sha256()
                with open(base + shard_ext(sid) + ".tmp", "rb") as sf:
                    for chunk in iter(lambda: sf.read(1 << 20), b""):
                        digest.update(chunk)
                        hashed += len(chunk)
                sums.append(digest.hexdigest())
            if span is not None:
                span.tags.update(bytes=hashed, shards=TOTAL_SHARDS)
        encoder.save_volume_info(vif_tmp, version=version,
                                 replication=replication, shard_sums=sums)
        # the 14 shards, the .ecx and the .vif
        with trace.start_span("store.commit", service="store", files=TOTAL_SHARDS + 2):
            sc.commit()
    except BaseException:
        sc.abort()
        raise
    return list(range(TOTAL_SHARDS))


# a codec, or a function that returns one: called only when an interval has
# to be reconstructed, so reads of local shards need no device
CodecArg = "Codec | Callable[[], Codec]"


def read_ec_shard_needle(ev: EcVolume, codec: CodecArg, needle_id: int,
                         remote_read: Optional[RemoteShardReader] = None) -> Needle:
    """Read one needle from an EC volume (store_ec.go:122). An interval on a
    shard that is not local is fetched through ``remote_read``, else
    reconstructed through ``codec``."""
    _, size, intervals = ev.locate_needle(needle_id)
    blob = b"".join(_read_interval(ev, codec, iv, remote_read) for iv in intervals)
    n = Needle.from_bytes(blob, size, ev.version)
    if n.id != needle_id:
        raise EcNotFoundError(f"unexpected needle {n.id:x} != {needle_id:x}")
    return n


class EcNeedleReader:
    """Byte spans of one needle record of an EC volume, read without the
    rest of it: only the intervals that hold wanted bytes are read, locally,
    from a remote holder, or reconstructed through ``codec``, and the pieces
    of one interval that lie within a small block of each other are read
    together. A ranged GET reads the header and data size, then the flags
    byte and the range, so a lost shard is rebuilt only where those bytes
    lie. Nothing here checks the needle's CRC, which covers all of its
    data."""

    def __init__(self, ev: EcVolume, codec: CodecArg, needle_id: int,
                 remote_read: Optional[RemoteShardReader] = None):
        self.ev, self.codec, self.remote_read = ev, codec, remote_read
        _, self.size, self.intervals = ev.locate_needle(needle_id)
        self._starts = list(itertools.accumulate(
            (iv.size for iv in self.intervals), initial=0))
        self.record_size = self._starts[-1]

    def _pieces(self, start: int, size: int):
        """(interval index, lo, hi) of the record's bytes [start,
        start + size), lo and hi relative to the interval."""
        end = start + size
        for i, iv in enumerate(self.intervals):
            base = self._starts[i]
            lo, hi = max(start, base), min(end, base + iv.size)
            if lo < hi:
                yield i, lo - base, hi - base

    def read(self, spans: list[tuple[int, int]]) -> list[bytes]:
        """The record's bytes [start, start + size) for each
        ``(start, size)`` of ``spans``."""
        runs: dict[int, list[list[int]]] = {}
        for start, size in spans:
            for i, lo, hi in self._pieces(start, size):
                for run in runs.setdefault(i, []):
                    if max(hi, run[1]) - min(lo, run[0]) <= SMALL_BLOCK_SIZE:
                        run[0], run[1] = min(lo, run[0]), max(hi, run[1])
                        break
                else:
                    runs[i].append([lo, hi])
        got: dict[int, list[tuple[int, bytes]]] = {}
        for i, extents in runs.items():
            iv = self.intervals[i]
            for lo, hi in extents:
                part = dataclasses.replace(
                    iv, inner_block_offset=iv.inner_block_offset + lo, size=hi - lo)
                got.setdefault(i, []).append(
                    (lo, _read_interval(self.ev, self.codec, part, self.remote_read)))

        def piece(i: int, lo: int, hi: int) -> bytes:
            off, buf = next((off, buf) for off, buf in got[i]
                            if off <= lo and hi <= off + len(buf))
            return buf[lo - off: hi - off]

        return [b"".join(piece(i, lo, hi) for i, lo, hi in self._pieces(start, size))
                for start, size in spans]


def _read_interval(ev: EcVolume, codec: CodecArg, interval,
                   remote_read: Optional[RemoteShardReader]) -> bytes:
    with trace.start_span("store.ec_read", service="store", bytes=interval.size):
        try:
            return ev.read_interval_local(interval)
        except NeedsShardError:
            sid, soff = interval.to_shard_id_and_offset(
                LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, ev.data_shards)
            if remote_read is not None:
                data = _fetch_remote(remote_read, ev.id, sid, soff, interval.size)
                if data is not None:
                    return data
            return recover_interval(ev, codec, sid, soff, interval.size, remote_read)


def _fetch_remote(remote_read: RemoteShardReader, vid: int, sid: int, offset: int,
                  size: int) -> Optional[bytes]:
    """One remote shard fetch, under its span."""
    with trace.start_span("store.fetch_sibling", service="store", shard=sid) as span:
        data = remote_read(vid, sid, offset, size)
        if span is not None:
            span.tags["bytes"] = 0 if data is None else len(data)
    return data


def recover_interval(ev: EcVolume, codec: CodecArg, missing_shard: int,
                     offset: int, size: int,
                     remote_read: Optional[RemoteShardReader] = None) -> bytes:
    """Read the same byte range from k sibling shards and RS-decode it
    (recoverOneRemoteEcShardInterval, store_ec.go:322). The local siblings
    are read first; the remote ones still needed are fetched through
    ``remote_read`` concurrently, and a sibling that cannot be had is
    replaced by the next one."""
    shards: list[Optional[np.ndarray]] = [None] * ev.total_shards
    have, remote = 0, []
    for sid in range(ev.total_shards):
        if sid == missing_shard:
            continue
        local = ev.shards.get(sid)
        if local is None:
            remote.append(sid)
            continue
        buf = local.read_at(offset, size)
        if len(buf) == size:
            shards[sid] = np.frombuffer(buf, dtype=np.uint8)
            have += 1
        if have >= ev.data_shards:
            break
    if have < ev.data_shards and remote and remote_read is not None:
        have += _fetch_siblings(ev.id, remote, ev.data_shards - have, offset, size,
                                remote_read, shards)
    if have < ev.data_shards:
        raise EcNotFoundError(
            f"volume {ev.id} shard {missing_shard}: only {have} shards reachable")
    if not isinstance(codec, Codec):
        codec = codec()
    with trace.start_span("store.reconstruct", service="store", shard=missing_shard,
                          bytes=size):
        rebuilt = codec.reconstruct(shards, data_only=missing_shard < ev.data_shards)
    return rebuilt[missing_shard].tobytes()


def _fetch_siblings(vid: int, candidates: list[int], need: int, offset: int, size: int,
                    remote_read: RemoteShardReader,
                    shards: list[Optional[np.ndarray]]) -> int:
    """Fetch ``need`` of the ``candidates`` shards' ranges at once, starting
    the next candidate only when one fails; fills ``shards`` and returns how
    many arrived. Each fetch runs in a copy of the caller's context, so it
    carries the request's trace span and deadline."""
    ctx = contextvars.copy_context()
    pending = iter(candidates)
    got = 0
    with ThreadPoolExecutor(max_workers=need, thread_name_prefix="ec-sibling") as pool:
        def start(sid: int):
            return pool.submit(ctx.copy().run, _fetch_remote, remote_read, vid, sid, offset,
                               size)

        running = {start(sid): sid for sid in itertools.islice(pending, need)}
        while running:
            done, _ = wait(running, return_when=FIRST_COMPLETED)
            for fut in done:
                sid = running.pop(fut)
                buf = fut.result()
                if buf is not None and len(buf) == size:
                    shards[sid] = np.frombuffer(buf, dtype=np.uint8)
                    got += 1
                else:
                    nxt = next(pending, None)
                    if nxt is not None:
                        running[start(nxt)] = nxt
    return got


# -- the Store ---------------------------------------------------------------
class Store:
    def __init__(
        self,
        directories: list[str],
        ip: str = "localhost",
        port: int = 8080,
        public_url: str = "",
        ec_backend: Optional[str] = None,
        needle_map_kind: str = "dense",
        remote_fetch_attempts: int = 3,
        remote_fetch_backoff_s: float = 0.05,
        remote_fetch_timeout_s: float = 5.0,
    ):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.needle_map_kind = needle_map_kind
        # degraded-read remote fetch policy: bounded attempts, exponential
        # backoff and a deadline, so a wedged peer degrades to
        # reconstruction instead of hanging the read
        self.remote_fetch_attempts = remote_fetch_attempts
        self.remote_fetch_backoff_s = remote_fetch_backoff_s
        self.remote_fetch_timeout_s = remote_fetch_timeout_s
        # the needle CRC's native library is built (or loaded) here, before
        # any volume is opened: never at a first write under a volume's lock
        crc.implementation()
        self.locations = [DiskLocation(d, needle_map_kind=needle_map_kind)
                          for d in directories]
        for loc in self.locations:
            loc.load_existing_volumes()
        # "cuda" (the default) runs the hand-written kernel and raises
        # without a card; "mesh" runs it on every local card
        # (ec/sharded.py); only "cpu" selects the plain version
        self.ec_backend = ec_backend or "cuda"
        if self.ec_backend not in ("cuda", "cpu", "mesh"):
            raise ValueError(f"ec backend {self.ec_backend!r}: want cuda, cpu or mesh")
        self._ec_codec: Optional[Codec] = None
        self._codec_lock = make_lock("Store._codec_lock")
        # the native data plane (storage/turbo.py), set by the volume server
        # when the engine owns its public port
        self.turbo_engine = None
        self.remote_shard_reader: Optional[RemoteShardReader] = None
        # delta queues drained by the heartbeat loop (store.go:33-50);
        # delta_event wakes it for an instant delta beat
        self.new_volumes: deque[dict] = deque()
        self.deleted_volumes: deque[dict] = deque()
        self.new_ec_shards: deque[dict] = deque()
        self.deleted_ec_shards: deque[dict] = deque()
        self.delta_event = threading.Event()
        # EC volumes have no Volume.read_heat: theirs lives here
        self.ec_read_heat: dict[int, heat.EwmaHeat] = {}
        # the engine's per-volume read and write counts already turned into
        # heat, by vid (``_take_engine_heat``)
        self._engine_heat_seen: dict[int, tuple[int, int]] = {}
        # scrub findings (corrupt needle / shard ids per vid), carried in
        # heartbeats; cleared when the local copy is deleted, re-copied or
        # rebuilt
        self.corrupt_needles: dict[int, set[int]] = {}
        self.corrupt_shards: dict[int, set[int]] = {}
        self._lock = make_rlock("Store._lock")
        heat.register_store(self)

    @property
    def device_backend(self) -> str:
        """The device the store's other device work (a ``/_query`` scan)
        runs on: the CPU under the ``cpu`` codec, else the card."""
        return "cpu" if self.ec_backend == "cpu" else "cuda"

    @property
    def ec_codec(self) -> Codec:
        """The EC codec, built on first use (once, whichever request thread
        gets here first)."""
        with self._codec_lock:
            if self._ec_codec is None:
                self._ec_codec = get_codec(device=self.ec_backend)
            return self._ec_codec

    # -- volume management (store.go:120-200) --------------------------------
    def add_volume(self, vid: int, collection: str = "",
                   replica_placement: "str | ReplicaPlacement" = "000",
                   ttl: "str | TTL" = "") -> Volume:
        if self.find_volume(vid) is not None:
            raise ValueError(f"volume {vid} already exists")
        if isinstance(replica_placement, str):
            replica_placement = ReplicaPlacement.from_string(replica_placement)
        if isinstance(ttl, str):
            ttl = read_ttl(ttl) if ttl else EMPTY_TTL
        loc = min(self.locations, key=lambda l: l.volume_count())
        v = Volume(loc.directory, collection, vid, replica_placement, ttl,
                   needle_map_kind=self.needle_map_kind)
        loc.add_volume(v)
        self.attach_turbo_volume(v)
        self.queue_new_volume(v)
        return v

    def attach_turbo_volume(self, v: Volume) -> None:
        """Hand a volume's data plane to the native engine, if one is up.
        A replicated volume keeps its HTTP writes in Python (the fan-out),
        but the engine still owns its appends and index."""
        if self.turbo_engine is None:
            return
        writable_http = v.super_block.replica_placement.copy_count() == 1
        v.attach_turbo(self.turbo_engine, writable_http)

    def attach_turbo_all(self) -> None:
        for loc in self.locations:
            for v in list(loc.volumes.values()):
                self.attach_turbo_volume(v)

    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.find_volume(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            ev = loc.find_ec_volume(vid)
            if ev is not None:
                return ev
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def delete_volume(self, vid: int) -> bool:
        v = self.find_volume(vid)
        msg = self._volume_message(v) if v is not None else {"id": vid}
        for loc in self.locations:
            if loc.delete_volume(vid):
                self.queue_deleted_volume(msg)
                return True
        return False

    def unmount_volume(self, vid: int) -> bool:
        """Stop serving a volume but keep its files, announcing the removal
        as delete_volume does (VolumeUnmount)."""
        v = self.find_volume(vid)
        if v is None:
            return False
        msg = self._volume_message(v)
        for loc in self.locations:
            if loc.unload_volume(vid):
                self.queue_deleted_volume(msg)
                return True
        return False

    def mount_volume(self, vid: int) -> Optional[Volume]:
        """(Re)load exactly this one volume from disk and announce it."""
        v = self.find_volume(vid)
        if v is not None:
            return v
        for loc in self.locations:
            for name in os.listdir(loc.directory):
                if not name.endswith(".dat"):
                    continue
                try:
                    collection, v_id = parse_volume_base_name(name[:-4])
                except ValueError:
                    continue
                if v_id != vid:
                    continue
                v = Volume(loc.directory, collection, vid, create_if_missing=False,
                           needle_map_kind=loc.needle_map_kind)
                loc.add_volume(v)
                self.attach_turbo_volume(v)
                self.queue_new_volume(v)
                return v
        return None

    # -- delta beat plumbing -------------------------------------------------
    def queue_new_volume(self, v: Volume) -> None:
        with self._lock:
            self.new_volumes.append(self._volume_message(v))
        self.delta_event.set()

    def queue_deleted_volume(self, msg: dict) -> None:
        """Announce a volume's removal; ``msg`` is its ``_volume_message``
        from before the change (the master unregisters it from the layout
        that message names)."""
        with self._lock:
            self.deleted_volumes.append(msg)
        self.delta_event.set()

    def queue_new_ec_shards(self, vid: int, collection: str, bits: int) -> None:
        with self._lock:
            self.new_ec_shards.append({"id": vid, "collection": collection,
                                       "ec_index_bits": bits})
        self.delta_event.set()

    def queue_deleted_ec_shards(self, vid: int, collection: str, bits: int) -> None:
        with self._lock:
            self.deleted_ec_shards.append({"id": vid, "collection": collection,
                                           "ec_index_bits": bits})
        self.delta_event.set()

    def drain_deltas(self) -> dict:
        """Pop all queued delta messages; an empty dict when none."""
        with self._lock:
            out = {}
            for key, q in (("new_volumes", self.new_volumes),
                           ("deleted_volumes", self.deleted_volumes),
                           ("new_ec_shards", self.new_ec_shards),
                           ("deleted_ec_shards", self.deleted_ec_shards)):
                if q:
                    out[key] = list(q)
                    q.clear()
            self.delta_event.clear()
            return out

    def mark_volume_readonly(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = True
        return True

    def mark_volume_writable(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = False
        return True

    # -- needle ops (store.go:299-340) ---------------------------------------
    def write_volume_needle(self, vid: int, n: Needle,
                            fsync: bool = False) -> tuple[int, int, bool]:
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        v.write_heat.mark()
        return v.write_needle(n, fsync=fsync)

    def delete_volume_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            ev = self.find_ec_volume(vid)
            if ev is not None:
                ev.delete_needle(n.id)
                return 0
            raise NotFoundError(f"volume {vid} not found")
        v.write_heat.mark()
        return v.delete_needle(n)

    def read_volume_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is not None:
            v.read_heat.mark()
            return v.read_needle(n)
        ev = self.find_ec_volume(vid)
        if ev is not None:
            return self.read_ec_shard_needle(ev, n)
        raise NotFoundError(f"volume {vid} not found")

    def read_volume_needle_extent(self, vid: int, n: Needle, min_size: int = 0):
        """Zero-copy read setup of a plain volume's needle
        (``Volume.read_needle_extent``); None for an EC volume, whose data
        has no contiguous extent on disk (the caller reads buffered)."""
        v = self.find_volume(vid)
        if v is None:
            return None
        v.read_heat.mark()
        return v.read_needle_extent(n, min_size)

    def note_volume_read(self, vid: int) -> None:
        """Count a read answered without touching the volume (a hot-needle
        cache hit): the heat signal must still see it."""
        v = self.find_volume(vid)
        if v is not None:
            v.read_heat.mark()

    # -- EC encode -----------------------------------------------------------
    def ec_encode_volume(self, vid: int) -> list[int]:
        """Seal volume ``vid`` and stripe it into 14 shards + .ecx + .vif
        under the staged commit (VolumeEcShardsGenerate). The codec is
        built before anything is sealed or staged, so a missing device
        writes nothing."""
        v = self.find_volume(vid)
        if v is None:
            raise NotFoundError(f"volume {vid} not found")
        codec = self.ec_codec
        v.read_only = True
        v.sync()
        return ec_encode_volume(v.file_name(), codec, version=v.version,
                                replication=str(v.super_block.replica_placement))

    # -- scrub findings (carried in heartbeats) ------------------------------
    def report_corrupt_needle(self, vid: int, nid: int) -> None:
        with self._lock:
            found = self.corrupt_needles.setdefault(vid, set())
            if nid in found:
                return  # already flagged: no new delta beat
            found.add(nid)
        self.delta_event.set()

    def report_corrupt_shard(self, vid: int, sid: int) -> None:
        with self._lock:
            found = self.corrupt_shards.setdefault(vid, set())
            if sid in found:
                return
            found.add(sid)
        self.delta_event.set()

    def clear_corrupt(self, vid: int, shard_ids=None) -> None:
        """Forget the findings for a vid: the local copy was deleted,
        re-fetched or rebuilt."""
        with self._lock:
            self.corrupt_needles.pop(vid, None)
            if shard_ids is None:
                self.corrupt_shards.pop(vid, None)
            else:
                left = self.corrupt_shards.get(vid)
                if left is not None:
                    left -= set(shard_ids)
                    if not left:
                        self.corrupt_shards.pop(vid, None)

    # -- EC read path (store_ec.go:122-375) ----------------------------------
    def read_ec_shard_needle(self, ev: EcVolume, n: Needle) -> int:
        self.note_ec_read(ev.id)
        m = read_ec_shard_needle(ev, lambda: self.ec_codec, n.id, self._remote_shard_read)
        n.__dict__.update(m.__dict__)
        return len(n.data)

    def ec_needle_reader(self, ev: EcVolume, needle_id: int) -> EcNeedleReader:
        """A reader of byte spans of one EC needle, on this store's codec
        and remote reader; the caller marks the read (``note_ec_read``)."""
        return EcNeedleReader(ev, lambda: self.ec_codec, needle_id,
                              self._remote_shard_read)

    def note_ec_read(self, vid: int) -> None:
        with self._lock:
            h = self.ec_read_heat.setdefault(vid, heat.EwmaHeat())
        h.mark()

    def _remote_shard_read(self, vid: int, sid: int, offset: int,
                           size: int) -> Optional[bytes]:
        """Remote shard fetch with bounded retry, backoff and deadline
        (store_ec.go readRemoteEcShardInterval). Returns None when the range
        cannot be had remotely, so the caller reconstructs it: at once when
        the reader reports that no server holds the shard."""
        if self.remote_shard_reader is None:
            return None

        def fetch():
            faultpoints.fire("ec.read.remote-fetch")
            data = self.remote_shard_reader(vid, sid, offset, size)
            if data is None or len(data) != size:
                # a short range is a failed attempt, not a success
                raise IOError(f"short/empty remote range for {vid}.{sid}")
            return data

        policy = RetryPolicy(
            attempts=max(1, self.remote_fetch_attempts),
            base_s=self.remote_fetch_backoff_s,
            cap_s=max(1.0, self.remote_fetch_backoff_s * 8),
            deadline_s=self.remote_fetch_timeout_s,
        )
        try:
            # every failure here (peer down, timeout, short read) heals the
            # same way: try again, then fall through to reconstruction; a
            # shard no server holds is not tried again
            return retry_call(
                fetch, policy=policy,
                classify=lambda e: POISON if isinstance(e, NoShardHolderError) else TRANSIENT,
                on_retry=lambda e, attempt, delay: glog.warning(
                    "remote shard %d.%d fetch attempt %d failed: %s",
                    vid, sid, attempt, e),
            )
        except RetryError:
            return None

    # -- heartbeat (store.go:204-297) ----------------------------------------
    def _take_engine_heat(self, v: Volume) -> None:
        """Mark into ``v``'s heat the needle reads and writes the native
        engine answered for it since the last call (the engine counts them
        per volume, across its registrations; what it proxies, Python marks
        itself). A count below the last one seen comes from a new engine,
        so all of it is new."""
        engine = v.turbo
        if engine is None:
            return
        with self._lock:
            try:
                s = engine.stats(v.id)
            except KeyError:
                return  # detached meanwhile
            reads, writes = s["reads"], s["writes"]
            seen_r, seen_w = self._engine_heat_seen.get(v.id, (0, 0))
            self._engine_heat_seen[v.id] = (reads, writes)
        new_r = reads - seen_r if reads >= seen_r else reads
        new_w = writes - seen_w if writes >= seen_w else writes
        if new_r:
            v.read_heat.mark(new_r)
        if new_w:
            v.write_heat.mark(new_w)

    def _volume_message(self, v: Volume) -> dict:
        # every heartbeat and /status reads heat through here
        self._take_engine_heat(v)
        return {
            "id": v.id,
            "size": v.size(),
            "collection": v.collection,
            "file_count": v.file_count(),
            "delete_count": v.deleted_count(),
            "deleted_byte_count": v.deleted_size(),
            "read_only": v.read_only,
            "replica_placement": v.super_block.replica_placement.to_byte(),
            "version": v.version,
            "ttl": v.ttl.to_uint32(),
            "compact_revision": v.super_block.compaction_revision,
            "read_heat": round(v.read_heat.value(), 3),
            "write_heat": round(v.write_heat.value(), 3),
            "remote_tier": v.is_tiered(),
            "corrupt_needles": len(self.corrupt_needles.get(v.id, ())),
        }

    def collect_heartbeat(self) -> dict:
        volumes = []
        max_file_key = 0
        for loc in self.locations:
            for v in list(loc.volumes.values()):
                max_file_key = max(max_file_key, v.max_file_key())
                volumes.append(self._volume_message(v))
        return {
            "ip": self.ip,
            "port": self.port,
            "public_url": self.public_url,
            "max_file_key": max_file_key,
            "max_volume_count": sum(l.max_volume_count for l in self.locations),
            "volumes": volumes,
        }

    def collect_ec_heartbeat(self) -> dict:
        ec_shards = []
        for loc in self.locations:
            for ev in list(loc.ec_volumes.values()):
                h = self.ec_read_heat.get(ev.id)
                ec_shards.append({
                    "id": ev.id,
                    "collection": ev.collection,
                    "ec_index_bits": sum(1 << sid for sid in ev.shard_ids()),
                    "read_heat": round(h.value(), 3) if h else 0.0,
                    "corrupt_shards": sorted(self.corrupt_shards.get(ev.id, ())),
                })
        return {"ip": self.ip, "port": self.port, "ec_shards": ec_shards}

    def close(self) -> None:
        for loc in self.locations:
            loc.close()
