"""wdclient: client-side master session with a cached volume-location map.

Reference: `weed/wdclient/masterclient.go:16,48,96` (KeepConnectedToMaster
subscribing to the master's VolumeLocation push stream) and
`weed/wdclient/vid_map.go:24,49,70` (the vid → locations cache behind
`LookupFileId`). Filers and gateways hold one of these so hot-path reads
never block on a master round-trip.

The port's copy of the JAX package's ``wdclient.py``. The reference's bidi
gRPC stream is an HTTP long-poll against the master's ``/cluster/watch``
(``server/master_server.py``), with the same versioned-delta semantics: the
master resends a full snapshot when the client falls behind the retained
log, as a stream reconnect replays everything. Either package's master
serves the feed.
"""

from __future__ import annotations

import random
import threading
from typing import Optional

from .server.http_util import http_json
from .storage.file_id import FileId


class Location:
    __slots__ = ("url", "public_url")

    def __init__(self, url: str, public_url: str = ""):
        self.url = url
        self.public_url = public_url or url

    def __eq__(self, other):
        return isinstance(other, Location) and self.url == other.url

    def __hash__(self):
        return hash(self.url)

    def __repr__(self):
        return f"Location({self.url})"


class VidMap:
    """vid → [Location] cache (wdclient/vid_map.go:24)."""

    def __init__(self):
        self._locations: dict[int, list[Location]] = {}
        self._lock = threading.RLock()

    def lookup_volume(self, vid: int) -> list[Location]:
        with self._lock:
            return list(self._locations.get(vid, ()))

    def lookup_volume_url(self, vid: int) -> Optional[str]:
        locs = self.lookup_volume(vid)
        return random.choice(locs).url if locs else None

    def add_location(self, vid: int, loc: Location) -> None:
        with self._lock:
            locs = self._locations.setdefault(vid, [])
            if loc not in locs:
                locs.append(loc)

    def delete_location(self, vid: int, url: str) -> None:
        with self._lock:
            locs = self._locations.get(vid)
            if locs:
                self._locations[vid] = [l for l in locs if l.url != url]
                if not self._locations[vid]:
                    del self._locations[vid]

    def invalidate(self, vid: int) -> None:
        """Drop every cached location for vid (stale-read eviction)."""
        with self._lock:
            self._locations.pop(vid, None)

    def replace_all(self, snapshot: dict) -> None:
        """Install a full vid → [{url, public_url}] snapshot."""
        fresh = {
            int(vid): [Location(m["url"], m.get("public_url", "")) for m in locs]
            for vid, locs in snapshot.items()
        }
        with self._lock:
            self._locations = fresh

    def __len__(self):
        with self._lock:
            return len(self._locations)


def find_reachable_master(seeds: list[str], timeout: float = 2.0,
                          strict: bool = False) -> str:
    """First seed answering /cluster/status. Reachable beats leader-guessing:
    never pin to an address nobody verified. When none answer: '' under
    strict (callers that must not act on an unverified address), else the
    first seed."""
    for m in seeds:
        try:
            http_json("GET", f"http://{m}/cluster/status", timeout=timeout)
            return m
        # sweedlint: ok broad-except seed probe; an unreachable master is the expected case
        except Exception:  # noqa: BLE001 — an unreachable seed is the expected case
            continue
    if strict:
        return ""
    return seeds[0] if seeds else ""


class MasterClient:
    """Keeps a VidMap fresh by long-polling the master's location feed
    (wdclient/masterclient.go KeepConnectedToMaster); falls back to a
    synchronous `/dir/lookup` on cache miss."""

    def __init__(
        self,
        masters: list[str] | str,
        client_name: str = "client",
        poll_timeout: float = 10.0,
    ):
        self.masters = [masters] if isinstance(masters, str) else list(masters)
        self.client_name = client_name
        self.poll_timeout = poll_timeout
        self.vid_map = VidMap()
        self.current_master: Optional[str] = None
        self._version = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- leader discovery (masterclient.go:48 tryAllMasters) ------------------
    def _find_master(self) -> Optional[str]:
        for m in self.masters:
            try:
                st = http_json("GET", f"http://{m}/cluster/status", timeout=3.0)
                leader = st.get("leader") or m
                return leader
            # sweedlint: ok broad-except master probe; try the next seed
            except Exception:  # noqa: BLE001 — try the next seed
                continue
        return None

    # -- background keep-connected loop ---------------------------------------
    def start(self) -> "MasterClient":
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.is_set():
            master = self._find_master()
            if master is None:
                self._stop.wait(1.0)
                continue
            if master != self.current_master:
                # new session: bootstrap from a full snapshot, like a fresh
                # KeepConnected stream receiving the complete location set
                self.current_master = master
                self._version = -1
            try:
                r = http_json(
                    "GET",
                    f"http://{master}/cluster/watch"
                    f"?since={self._version}&timeout={self.poll_timeout}",
                    timeout=self.poll_timeout + 20.0,
                )
            except Exception:  # noqa: BLE001 — resync below
                r = None
            if r is None or r.get("error") or "version" not in r:
                # transport failure OR an error-shaped body (http_json maps
                # HTTP errors to {'error': ...} instead of raising): back
                # off and resync from a fresh snapshot
                self.current_master = None
                self._stop.wait(0.5)
                continue
            self._apply(r)

    def _apply(self, r: dict) -> None:
        if "snapshot" in r:
            self.vid_map.replace_all(r["snapshot"])
        else:
            for e in r.get("events", ()):
                loc = Location(e["url"], e.get("public_url", ""))
                if e.get("deleted"):
                    self.vid_map.delete_location(e["vid"], e["url"])
                else:
                    self.vid_map.add_location(e["vid"], loc)
        self._version = r.get("version", self._version)

    # -- lookups (vid_map.go:49 LookupFileId) ---------------------------------
    def lookup_volume(self, vid: int) -> list[Location]:
        locs = self.vid_map.lookup_volume(vid)
        if locs:
            return locs
        master = self.current_master or self._find_master()
        if master is None:
            return []
        try:
            r = http_json("GET", f"http://{master}/dir/lookup?volumeId={vid}")
        except Exception:  # noqa: BLE001 — an unknown vid reads as no location
            return []
        for m in r.get("locations", ()):
            self.vid_map.add_location(
                vid,
                Location(m["url"], m.get("public_url") or m.get("publicUrl", "")),
            )
        return self.vid_map.lookup_volume(vid)

    def lookup_file_id(self, fid: str) -> list[str]:
        """fid → full http urls, like vid_map.go:49 LookupFileId."""
        file_id = FileId.parse(fid)
        return [
            f"http://{loc.url}/{fid}" for loc in self.lookup_volume(file_id.volume_id)
        ]
