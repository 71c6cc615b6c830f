"""DiskLocation: one data directory holding volumes and EC shards.

Mirrors `weed/storage/disk_location.go` (+ `disk_location_ec.go`): scans the
directory, loads every `<collection>_<vid>.dat` / `<vid>.dat` volume and every
`.ecx`-bearing EC volume, after resolving interrupted staged commits once per
process (storage/commit.py).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..ec.ec_volume import EcShardsError, EcVolume
from ..util import glog
from .commit import recover_directory
from .volume import Volume, check_needle_map_kind


def parse_volume_base_name(name: str) -> tuple[str, int]:
    """'col_3' → ('col', 3); '3' → ('', 3). Raises on non-volume names."""
    if "_" in name:
        collection, vid_str = name.rsplit("_", 1)
    else:
        collection, vid_str = "", name
    return collection, int(vid_str)


class DiskLocation:
    def __init__(self, directory: str, max_volume_count: int = 7,
                 needle_map_kind: str = "dense"):
        check_needle_map_kind(needle_map_kind)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.needle_map_kind = needle_map_kind
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self._lock = threading.RLock()
        self._recovered = False

    # -- loading (disk_location.go:104-160) ----------------------------------
    def load_existing_volumes(self) -> None:
        with self._lock:
            self._recover_staged_commits()
            for entry in sorted(os.listdir(self.directory)):
                if not os.path.isfile(os.path.join(self.directory, entry)):
                    continue
                base, ext = os.path.splitext(entry)
                try:
                    if ext == ".dat":
                        collection, vid = parse_volume_base_name(base)
                        if vid not in self.volumes:
                            self.volumes[vid] = Volume(
                                self.directory, collection, vid,
                                create_if_missing=False,
                                needle_map_kind=self.needle_map_kind,
                            )
                    elif ext == ".ecx":
                        collection, vid = parse_volume_base_name(base)
                        if vid not in self.ec_volumes:
                            ev = EcVolume(self.directory, collection, vid)
                            if ev.shards:
                                self.ec_volumes[vid] = ev
                            else:
                                ev.close()
                except EcShardsError as e:
                    # a torn shard set or a pending commit: never mount a
                    # half-consistent EC view (the plain volume still serves)
                    glog.error("not mounting ec volume %s: %s", base, e)
                except (ValueError, FileNotFoundError):
                    continue  # not a volume file

    def _recover_staged_commits(self) -> None:
        """Once per process, before any volume loads, roll interrupted
        two-phase commits forward or back. Startup only: a later rescan (a
        mount request) must not collect the staging files of an encode that
        is in flight."""
        if self._recovered:
            return
        self._recovered = True
        actions = recover_directory(self.directory)
        for kind in ("rolled_forward", "rolled_back"):
            for item in actions[kind]:
                glog.info("startup recovery: %s %s", kind, item)
        if actions["gc"]:
            glog.info("startup recovery: garbage-collected %d staged file(s): %s",
                      len(actions["gc"]), ", ".join(actions["gc"]))

    # -- volume management ---------------------------------------------------
    def add_volume(self, volume: Volume) -> None:
        with self._lock:
            self.volumes[volume.id] = volume

    def find_volume(self, vid: int) -> Optional[Volume]:
        return self.volumes.get(vid)

    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        return self.ec_volumes.get(vid)

    def unload_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.close()
            return True

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.destroy()
            return True

    def unload_ec_volume(self, vid: int) -> bool:
        with self._lock:
            ev = self.ec_volumes.pop(vid, None)
            if ev is None:
                return False
            ev.close()
            return True

    def volume_count(self) -> int:
        return len(self.volumes)

    def close(self) -> None:
        with self._lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
            self.volumes.clear()
            self.ec_volumes.clear()
