"""Master core: assignment, lookup, heartbeat intake, location push, locks.

The transport-agnostic heart of `weed/server/master_server.go` +
`master_grpc_server*.go`: volume servers feed heartbeats in, clients call
assign/lookup, subscribers receive volume-location deltas (the KeepConnected
stream), the admin shell takes the exclusive lock, and a vacuum scan drives
compaction through injected callbacks. The HTTP wrapper is
``server/master_server.py``.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..storage.file_id import FileId
from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, read_ttl
from ..util import glog
from .sequence import MemorySequencer
from .topology import DataNode, Topology
from .volume_growth import VolumeGrowOption, VolumeGrowth
from .volume_layout import NoWritableVolumesError


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    count: int
    replicas: list[str] = field(default_factory=list)


# push(event) where event = {"vid":…, "urls":[…], "deleted":bool}
LocationSubscriber = Callable[[dict], None]


class Master:
    def __init__(
        self,
        volume_size_limit: int = 30 * 1024 * 1024 * 1024,
        default_replication: str = "000",
        allocate_volume: Optional[Callable] = None,
        garbage_threshold: float = 0.3,
        pulse_seconds: float = 5.0,
    ):
        self.topo = Topology(volume_size_limit)
        self.sequencer = MemorySequencer()
        self.default_replication = ReplicaPlacement.from_string(default_replication)
        self.garbage_threshold = garbage_threshold
        self.pulse_seconds = pulse_seconds
        self.vg = VolumeGrowth(
            allocate_volume or self._reject_allocate,
            on_register=lambda vid, dn: self._notify(vid, dn, deleted=False),
        )
        self._subscribers: dict[str, LocationSubscriber] = {}
        self._admin_lock_token: Optional[str] = None
        self._admin_lock_ts = 0.0
        self._admin_lock_client = ""
        self._lock = threading.RLock()
        # versioned VolumeLocation delta log for remote KeepConnected
        # subscribers (clients long-poll /cluster/watch against this)
        self._loc_version = 0
        self._loc_log: deque = deque(maxlen=4096)
        self._loc_cond = threading.Condition(self._lock)

    @staticmethod
    def _reject_allocate(dn, vid, option):
        raise RuntimeError("no allocate_volume callback wired to master")

    # -- heartbeat intake (master_grpc_server.go:20-130) ---------------------
    def register_data_node(
        self,
        ip: str,
        port: int,
        public_url: str = "",
        data_center: str = "DefaultDataCenter",
        rack: str = "DefaultRack",
        max_volume_count: int = 7,
    ) -> DataNode:
        dc = self.topo.get_or_create_data_center(data_center)
        r = dc.get_or_create_rack(rack)
        dn = r.new_data_node(f"{ip}:{port}", ip, port, public_url, max_volume_count)
        dn.last_seen = time.time()
        return dn

    def handle_heartbeat(self, dn: DataNode, hb: dict) -> dict:
        """Full or delta heartbeat dict (Store.collect_heartbeat shape).
        Returns the ack (volume size limit + leader).

        Holds the master lock: a full sync racing a concurrent assign/grow
        (which registers new volumes under the same lock) must not replace
        the node's volume list with a pre-grow snapshot and unregister a
        volume whose fid was just handed out."""
        with self._lock:
            return self._handle_heartbeat_locked(dn, hb)

    def _handle_heartbeat_locked(self, dn: DataNode, hb: dict) -> dict:
        dn.last_seen = time.time()
        if "pulse_seconds" in hb:
            dn.pulse_seconds = float(hb["pulse_seconds"])
        if "max_file_key" in hb:
            self.sequencer.set_max(hb["max_file_key"])
        if "max_volume_count" in hb:
            dn._max_volume_count = hb["max_volume_count"]
        if "volumes" in hb:
            new_vis, deleted_vis = self.topo.sync_data_node_registration(
                dn, hb["volumes"]
            )
            for vi in new_vis:
                self._notify(vi.id, dn, deleted=False)
            for vi in deleted_vis:
                self._notify(vi.id, dn, deleted=True)
        if hb.get("new_volumes") or hb.get("deleted_volumes"):
            self.topo.incremental_sync(
                dn, hb.get("new_volumes", []), hb.get("deleted_volumes", [])
            )
            for m in hb.get("deleted_volumes", []):
                self._notify(m["id"], dn, deleted=True)
            for m in hb.get("new_volumes", []):
                self._notify(m["id"], dn, deleted=False)
        if "ec_shards" in hb:
            self.topo.sync_data_node_ec_shards(dn, hb["ec_shards"])
        # instant EC-shard deltas (master_grpc_server.go:83-98 incremental
        # branch): register/unregister only the changed shard bits
        for m in hb.get("new_ec_shards", []):
            self.topo.register_ec_shards(m["id"], dn, m.get("ec_index_bits", 0),
                                         m.get("collection"))
        for m in hb.get("deleted_ec_shards", []):
            self.topo.unregister_ec_shards(
                m["id"], dn, m.get("ec_index_bits", ~0)
            )
        return {"volume_size_limit": self.topo.volume_size_limit}

    def handle_node_disconnect(self, dn: DataNode) -> None:
        affected = self.topo.unregister_data_node(dn)
        for vid in affected:
            self._notify(vid, dn, deleted=True)

    # -- location push (KeepConnected) ---------------------------------------
    def subscribe(self, client_name: str, fn: LocationSubscriber) -> None:
        self._subscribers[client_name] = fn

    def unsubscribe(self, client_name: str) -> None:
        self._subscribers.pop(client_name, None)

    def _notify(self, vid: int, dn: DataNode, deleted: bool) -> None:
        # location-scoped, like the reference's VolumeLocation push:
        # deleted=True means "this url no longer serves vid", NOT that the
        # volume is gone — subscribers evict the (vid, url) pair only.
        event = {
            "vid": vid,
            "url": dn.url(),
            "public_url": dn.public_url or dn.url(),
            "deleted": deleted,
        }
        for fn in list(self._subscribers.values()):
            try:
                fn(event)
            except Exception:
                glog.exception("volume-location subscriber failed")
        with self._loc_cond:
            self._loc_version += 1
            self._loc_log.append((self._loc_version, event))
            self._loc_cond.notify_all()

    def location_snapshot(self) -> dict:
        """Full vid → [{url, public_url}] map from the current topology."""
        locs: dict[int, list[dict]] = {}
        with self._lock:
            for dn in self.topo.data_nodes():
                for vid in dn.volumes:
                    locs.setdefault(vid, []).append(
                        {"url": dn.url(), "public_url": dn.public_url or dn.url()}
                    )
        return {str(vid): v for vid, v in locs.items()}

    def location_deltas(self, since: int, timeout: float = 0.0) -> dict:
        """Events after version `since`; blocks up to `timeout` if none yet.

        If `since` predates the retained log window, returns a full snapshot
        instead (the caller must replace, not merge, its vid map) — the
        KeepConnected stream's reconnect-resends-everything behavior
        (master_grpc_server.go:99-120).
        """
        if since < 0:
            with self._loc_cond:
                version = self._loc_version
            return {"version": version, "snapshot": self.location_snapshot()}
        with self._loc_cond:
            if self._loc_version == since and timeout > 0:
                self._loc_cond.wait(timeout)
            oldest = self._loc_log[0][0] if self._loc_log else self._loc_version + 1
            if since + 1 < oldest and self._loc_version > since:
                return {
                    "version": self._loc_version,
                    "snapshot": self.location_snapshot(),
                }
            events = [e for v, e in self._loc_log if v > since]
            return {"version": self._loc_version, "events": events}

    def release_watchers(self) -> None:
        """Wake every ``location_deltas`` long-poll now: a stopping master's
        watchers get what there is, instead of holding their handler
        threads (and the process's exit) for up to their timeout."""
        with self._loc_cond:
            self._loc_cond.notify_all()

    # -- assignment (master_server_handlers.go:96-150) -----------------------
    def assign(
        self,
        count: int = 1,
        replication: str = "",
        collection: str = "",
        ttl: str = "",
        data_center: str = "",
        writable_volume_count: int = 0,
    ) -> AssignResult:
        rp = (
            ReplicaPlacement.from_string(replication)
            if replication
            else self.default_replication
        )
        ttl_obj = read_ttl(ttl) if ttl else EMPTY_TTL
        layout = self.topo.get_volume_layout(collection, rp, ttl_obj)
        option = VolumeGrowOption(
            collection=collection,
            replica_placement=rp,
            ttl=ttl_obj,
            data_center=data_center,
        )
        with self._lock:
            if layout.active_volume_count() == 0:
                grow = writable_volume_count or VolumeGrowth.default_grow_count(rp)
                self.vg.grow_by_count(self.topo, option, grow)
            try:
                vid, locations = layout.pick_for_write(data_center)
            except NoWritableVolumesError:
                grow = writable_volume_count or VolumeGrowth.default_grow_count(rp)
                self.vg.grow_by_count(self.topo, option, grow)
                vid, locations = layout.pick_for_write(data_center)
        key = self.sequencer.next_file_id(count)
        cookie = secrets.randbits(32)
        fid = str(FileId(vid, key, cookie))
        main = locations[0]
        return AssignResult(
            fid=fid,
            url=main.url(),
            public_url=main.public_url or main.url(),
            count=count,
            replicas=[dn.url() for dn in locations[1:]],
        )

    # -- lookup (master_server_handlers.go:32-60) ----------------------------
    def lookup_volume(self, vid: int, collection: str = "") -> list[dict]:
        locations = self.topo.lookup(collection, vid)
        if not locations:
            # EC volumes are located per shard
            by_shard = self.topo.lookup_ec_shards(vid)
            nodes = {dn.id: dn for locs in by_shard.values() for dn in locs}
            locations = list(nodes.values())
        return [{"url": dn.url(), "public_url": dn.public_url or dn.url()} for dn in locations]

    def lookup_ec_volume(self, vid: int) -> dict:
        by_shard = self.topo.lookup_ec_shards(vid)
        return {
            "volume_id": vid,
            "shard_id_locations": {
                sid: [dn.url() for dn in nodes] for sid, nodes in by_shard.items()
            },
        }

    # -- collections ---------------------------------------------------------
    def collection_list(self) -> list[str]:
        return self.topo.collection_names()

    def collection_delete(self, name: str) -> list[int]:
        return self.topo.delete_collection(name)

    # -- admin lock (master_grpc_server_admin.go:65-113) ---------------------
    def lease_admin_token(
        self, client_name: str, previous_token: Optional[str] = None
    ) -> str:
        with self._lock:
            now = time.time()
            expired = now - self._admin_lock_ts > 60
            if (
                self._admin_lock_token is None
                or expired
                or self._admin_lock_token == previous_token
            ):
                self._admin_lock_token = previous_token or secrets.token_hex(16)
                self._admin_lock_ts = now
                self._admin_lock_client = client_name
                return self._admin_lock_token
            raise RuntimeError(f"admin lock held by {self._admin_lock_client}")

    def release_admin_token(self, token: str) -> None:
        with self._lock:
            if self._admin_lock_token == token:
                self._admin_lock_token = None

    # -- vacuum orchestration (topology_vacuum.go:147) -----------------------
    def vacuum(
        self,
        check_garbage: Callable[[DataNode, int], float],
        compact: Callable[[DataNode, int], bool],
        garbage_threshold: Optional[float] = None,
    ) -> list[int]:
        """Scan all layouts; for each volume whose max replica garbage ratio
        exceeds the threshold, run compaction on every replica. The two
        callbacks abstract the volume-server RPCs. Returns compacted vids."""
        threshold = (
            self.garbage_threshold if garbage_threshold is None else garbage_threshold
        )
        compacted = []
        for layout in list(self.topo.layouts.values()):
            for vid, locations in list(layout.vid2location.items()):
                if not locations:
                    continue
                try:
                    ratio = max(check_garbage(dn, vid) for dn in locations)
                except Exception as e:
                    glog.V(2).info("vacuum check vid %s failed: %s", vid, e)
                    continue
                if ratio < threshold:
                    continue
                with layout._lock:
                    layout._remove_from_writable(vid)
                try:
                    ok = True
                    for dn in list(locations):
                        try:
                            ok = compact(dn, vid) and ok
                        except Exception:
                            ok = False  # unreachable replica: skip, keep scanning
                    if ok:
                        compacted.append(vid)
                finally:
                    with layout._lock:
                        layout._ensure_writable_state(vid)
        return compacted

    # -- cluster status ------------------------------------------------------
    def topology_info(self) -> dict:
        dcs = []
        for dc in self.topo.children.values():
            racks = []
            for rack in dc.children.values():
                nodes = [
                    {
                        "id": dn.id,
                        "url": dn.url(),
                        "volumes": len(dn.volumes),
                        "ec_shards": {
                            vid: bin(bits).count("1")
                            for vid, bits in dn.ec_shards.items()
                        },
                        "max": dn.max_volume_count(),
                    }
                    for dn in rack.children.values()
                    if isinstance(dn, DataNode)
                ]
                racks.append({"id": rack.id, "nodes": nodes})
            dcs.append({"id": dc.id, "racks": racks})
        return {
            "max_volume_id": self.topo.max_volume_id,
            "data_centers": dcs,
            "layouts": {
                f"{k[0] or '_'}/{k[1]}/{k[2] or '-'}": v.stats()
                for k, v in self.topo.layouts.items()
            },
        }
