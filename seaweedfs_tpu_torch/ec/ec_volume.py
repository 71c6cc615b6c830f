"""EC volume runtime: serve needle reads from erasure-coded shards.

Mirrors `weed/storage/erasure_coding/ec_volume.go`, `ec_shard.go`,
`ec_volume_delete.go`:

- an EC volume is the set of locally-present shard files (.ec00‥.ec13) plus
  the .ecx sorted index (binary-searched per lookup) and the .ecj deletion
  journal;
- a needle read locates (offset, size) in .ecx, maps the byte range to
  shard intervals (dat size = k × shard size), and reads whichever shards
  are local — missing-shard intervals surface as NeedsShardError so the
  caller (storage/store.py) can reconstruct them on the GPU;
- deletes tombstone the .ecx entry in place and append the id to .ecj;
  RebuildEcxFile replays .ecj after shard rebuilds.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Optional

from ..storage import idx as idx_mod
from ..storage.needle import get_actual_size
from ..storage.types import (
    NEEDLE_ID_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    needle_map_entry_size,
    size_is_valid,
)
from .constants import (
    DATA_SHARDS,
    LARGE_BLOCK_SIZE,
    SMALL_BLOCK_SIZE,
    TOTAL_SHARDS,
    shard_ext,
)
from .locate import Interval, locate_data


class NotFoundError(Exception):
    pass


class DeletedError(Exception):
    pass


class EcShardsError(Exception):
    """The local shard set is not safe to serve: shard sizes disagree (a
    torn write survived) or an encode commit is still pending for this
    volume. Mounting anyway would serve a half-consistent stripe view."""


def search_sorted_index(
    f, file_size: int, needle_id: int, offset_size: int = OFFSET_SIZE
) -> tuple[Optional[tuple[int, int, int]], int]:
    """Binary-search a sorted index stream (.ecx) for a needle id
    (SearchNeedleFromSortedIndex, ec_volume.go:210). Returns
    ((key, offset, size), entry_byte_offset) or (None, -1)."""
    entry_size = needle_map_entry_size(offset_size)
    lo, hi = 0, file_size // entry_size
    while lo < hi:
        mid = (lo + hi) // 2
        f.seek(mid * entry_size)
        key, offset, size = idx_mod.unpack_entry(f.read(entry_size), offset_size)
        if key == needle_id:
            return (key, offset, size), mid * entry_size
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    return None, -1


def tombstone_sorted_index_entry(
    f, entry_byte_offset: int, offset_size: int = OFFSET_SIZE
) -> None:
    """Mark an index entry deleted in place (MarkNeedleDeleted,
    ec_volume_delete.go:13-25)."""
    f.seek(entry_byte_offset + NEEDLE_ID_SIZE + offset_size)
    f.write(struct.pack(">i", TOMBSTONE_FILE_SIZE))


class NeedsShardError(Exception):
    """Raised when an interval lands on a shard not present locally."""

    def __init__(self, shard_id: int, interval: Interval):
        super().__init__(f"shard {shard_id} not local")
        self.shard_id = shard_id
        self.interval = interval


class EcVolumeShard:
    """One local shard file (ec_shard.go:16-99)."""

    def __init__(self, base_file_name: str, shard_id: int):
        self.shard_id = shard_id
        self.path = base_file_name + shard_ext(shard_id)
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)
        self._lock = threading.Lock()

    def read_at(self, offset: int, size: int) -> bytes:
        with self._lock:
            self._f.seek(offset)
            return self._f.read(size)

    def close(self) -> None:
        self._f.close()


class EcVolume:
    def __init__(
        self,
        directory: str,
        collection: str,
        vid: int,
        version: int = 3,
        offset_size: int = OFFSET_SIZE,
        data_shards: int = DATA_SHARDS,
        total_shards: int = TOTAL_SHARDS,
    ):
        from ..storage.volume import volume_file_name

        self.collection = collection
        self.id = vid
        self.version = version
        self.offset_size = offset_size
        self.data_shards = data_shards
        self.total_shards = total_shards
        self.base_file_name = volume_file_name(directory, collection, vid)
        self.shards: dict[int, EcVolumeShard] = {}
        self._ecx_lock = threading.Lock()
        self._ecj_lock = threading.Lock()
        from ..storage.commit import pending_commit

        if pending_commit(self.base_file_name):
            # an encode/vacuum/tier transition for this volume never reached
            # its cleanup step; startup recovery resolves it — mounting now
            # could see the shard set mid-rename
            raise EcShardsError(
                f"volume {vid} has a pending commit manifest"
            )
        ecx_path = self.base_file_name + ".ecx"
        if not os.path.exists(ecx_path):
            raise FileNotFoundError(ecx_path)
        self._ecx = open(ecx_path, "r+b")
        self.ecx_size = os.path.getsize(ecx_path)
        try:
            self._load_shards()
        except EcShardsError:
            self._ecx.close()
            raise

    def _load_shards(self) -> None:
        for sid in range(self.total_shards):
            path = self.base_file_name + shard_ext(sid)
            if os.path.exists(path) and sid not in self.shards:
                self.shards[sid] = EcVolumeShard(self.base_file_name, sid)
        # completeness: every RS stripe column spans all shards, so local
        # shard files must agree on size; a short one is a torn write that
        # escaped the commit protocol (manual copy, fs corruption) and
        # would silently corrupt reads and reconstructions
        sizes = {s.size for s in self.shards.values()}
        if len(sizes) > 1:
            raise EcShardsError(
                f"volume {self.id} shard sizes disagree: "
                + ", ".join(
                    f"{sid}:{s.size}" for sid, s in sorted(self.shards.items())
                )
            )

    def refresh_shards(self) -> None:
        self._load_shards()

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def shard_size(self) -> int:
        if not self.shards:
            return 0
        return next(iter(self.shards.values())).size

    def dat_file_size(self) -> int:
        """Original .dat size proxy: k × shard size (ec_volume.go:202)."""
        return self.data_shards * self.shard_size()

    # -- .ecx search (ec_volume.go:210-235) ----------------------------------
    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        """(actual offset, size) via binary search; raises NotFound/Deleted."""
        entry, _ = self._search_ecx(needle_id)
        if entry is None:
            raise NotFoundError(f"needle {needle_id:x} not in ecx")
        _, offset, size = entry
        if not size_is_valid(size):
            raise DeletedError(f"needle {needle_id:x} deleted")
        return offset, size

    def _search_ecx(
        self, needle_id: int
    ) -> tuple[Optional[tuple[int, int, int]], int]:
        with self._ecx_lock:
            return search_sorted_index(
                self._ecx, self.ecx_size, needle_id, self.offset_size
            )

    # -- needle location (ec_volume.go:190-204) ------------------------------
    def locate_needle(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        offset, size = self.find_needle_from_ecx(needle_id)
        intervals = locate_data(
            LARGE_BLOCK_SIZE,
            SMALL_BLOCK_SIZE,
            self.dat_file_size(),
            offset,
            get_actual_size(size, self.version),
            self.data_shards,
        )
        return offset, size, intervals

    def read_interval_local(self, interval: Interval) -> bytes:
        """Read one interval from a local shard; NeedsShardError otherwise."""
        sid, soff = interval.to_shard_id_and_offset(
            LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, self.data_shards
        )
        shard = self.shards.get(sid)
        if shard is None:
            raise NeedsShardError(sid, interval)
        return shard.read_at(soff, interval.size)

    def read_needle_blob(self, needle_id: int) -> bytes:
        """Full needle record bytes, local shards only (store_ec fallback
        layers — remote fetch / reconstruction — live in the Store)."""
        _, _, intervals = self.locate_needle(needle_id)
        return b"".join(self.read_interval_local(iv) for iv in intervals)

    # -- deletion (ec_volume_delete.go:27-49) --------------------------------
    def delete_needle(self, needle_id: int) -> None:
        entry, ecx_off = self._search_ecx(needle_id)
        if entry is None:
            return
        with self._ecx_lock:
            tombstone_sorted_index_entry(self._ecx, ecx_off, self.offset_size)
            self._ecx.flush()
        with self._ecj_lock:
            with open(self.base_file_name + ".ecj", "ab") as ecj:
                ecj.write(struct.pack(">Q", needle_id))

    def close(self) -> None:
        for s in self.shards.values():
            s.close()
        self._ecx.close()


def rebuild_ecx_file(base_file_name: str, offset_size: int = OFFSET_SIZE) -> None:
    """Replay .ecj deletions into a freshly rebuilt .ecx
    (ec_volume_delete.go:51-96), then remove the journal."""
    ecj_path = base_file_name + ".ecj"
    if not os.path.exists(ecj_path):
        return
    with open(base_file_name + ".ecx", "r+b") as ecx:
        ecx_size = os.path.getsize(base_file_name + ".ecx")
        with open(ecj_path, "rb") as ecj:
            while True:
                buf = ecj.read(8)
                if len(buf) != 8:
                    break
                needle_id = struct.unpack(">Q", buf)[0]
                entry, ecx_off = search_sorted_index(
                    ecx, ecx_size, needle_id, offset_size
                )
                if entry is not None:
                    tombstone_sorted_index_entry(ecx, ecx_off, offset_size)
    # tombstoning is idempotent, so a crash before this just replays the journal
    # sweedlint: ok durability post-apply cleanup; tombstoning is idempotent, a crash just replays the journal
    os.remove(ecj_path)
