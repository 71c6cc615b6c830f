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
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..ec import encoder
from ..ec.codec import Codec, get_codec
from ..ec.constants import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, TOTAL_SHARDS, shard_ext
from ..ec.ec_volume import EcVolume, NeedsShardError
from ..ec.ec_volume import NotFoundError as EcNotFoundError
from ..stats import heat
from ..util import faultpoints, glog
from ..util.locks import make_lock, make_rlock
from ..util.retry import TRANSIENT, RetryError, RetryPolicy, retry_call
from .commit import StagedCommit
from .disk_location import DiskLocation, parse_volume_base_name
from .needle import Needle
from .replica_placement import ReplicaPlacement
from .ttl import EMPTY_TTL, TTL, read_ttl
from .volume import NotFoundError, Volume

# remote_read(vid, shard_id, offset, size) -> bytes | None
RemoteShardReader = Callable[[int, int, int, int], Optional[bytes]]


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
        sums = []
        for sid in range(TOTAL_SHARDS):
            digest = hashlib.sha256()
            with open(base + shard_ext(sid) + ".tmp", "rb") as sf:
                for chunk in iter(lambda: sf.read(1 << 20), b""):
                    digest.update(chunk)
            sums.append(digest.hexdigest())
        encoder.save_volume_info(vif_tmp, version=version,
                                 replication=replication, shard_sums=sums)
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


def _read_interval(ev: EcVolume, codec: CodecArg, interval,
                   remote_read: Optional[RemoteShardReader]) -> bytes:
    try:
        return ev.read_interval_local(interval)
    except NeedsShardError:
        sid, soff = interval.to_shard_id_and_offset(
            LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, ev.data_shards)
        if remote_read is not None:
            data = remote_read(ev.id, sid, soff, interval.size)
            if data is not None:
                return data
        return recover_interval(ev, codec, sid, soff, interval.size, remote_read)


def recover_interval(ev: EcVolume, codec: CodecArg, missing_shard: int,
                     offset: int, size: int,
                     remote_read: Optional[RemoteShardReader] = None) -> bytes:
    """Read the same byte range from ≥k sibling shards, local or through
    ``remote_read``, and RS-decode it (recoverOneRemoteEcShardInterval,
    store_ec.go:322)."""
    shards: list[Optional[np.ndarray]] = [None] * ev.total_shards
    have = 0
    for sid in range(ev.total_shards):
        if sid == missing_shard:
            continue
        local = ev.shards.get(sid)
        if local is not None:
            buf = local.read_at(offset, size)
        elif remote_read is not None:
            buf = remote_read(ev.id, sid, offset, size)
        else:
            buf = None
        if buf is not None and len(buf) == size:
            shards[sid] = np.frombuffer(buf, dtype=np.uint8)
            have += 1
        if have >= ev.data_shards:
            break
    if have < ev.data_shards:
        raise EcNotFoundError(
            f"volume {ev.id} shard {missing_shard}: only {have} shards reachable")
    if not isinstance(codec, Codec):
        codec = codec()
    rebuilt = codec.reconstruct(shards, data_only=missing_shard < ev.data_shards)
    return rebuilt[missing_shard].tobytes()


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
        with self._lock:
            h = self.ec_read_heat.setdefault(ev.id, heat.EwmaHeat())
        h.mark()
        m = read_ec_shard_needle(ev, lambda: self.ec_codec, n.id, self._remote_shard_read)
        n.__dict__.update(m.__dict__)
        return len(n.data)

    def _remote_shard_read(self, vid: int, sid: int, offset: int,
                           size: int) -> Optional[bytes]:
        """Remote shard fetch with bounded retry, backoff and deadline
        (store_ec.go readRemoteEcShardInterval). Returns None when the range
        cannot be had remotely, so the caller reconstructs it."""
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
            # same way: try again, then fall through to reconstruction
            return retry_call(
                fetch, policy=policy, classify=lambda e: TRANSIENT,
                on_retry=lambda e, attempt, delay: glog.warning(
                    "remote shard %d.%d fetch attempt %d failed: %s",
                    vid, sid, attempt, e),
            )
        except RetryError:
            return None

    # -- heartbeat (store.go:204-297) ----------------------------------------
    def _volume_message(self, v: Volume) -> dict:
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
