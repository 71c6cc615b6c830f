"""Topology tree: DataCenter → Rack → DataNode, with volume/EC registries.

Mirrors `weed/topology/topology.go`, `node.go`, `data_node.go`,
`topology_ec.go`. The tree tracks capacity (volume slots) for placement; the
topology is rebuilt from heartbeats, never persisted.

Placement draws from the process-global ``random`` (``pick_nodes_by_weight``,
``reserve_one_volume``) in the same order as the JAX package's topology, so
both pick the same nodes after the same seed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import TTL
from ..util.locks import make_rlock
from ..util.racecheck import instrument


@dataclass
class VolumeInfo:
    """What the master knows about one volume replica (storage.VolumeInfo)."""

    id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    version: int = 3
    ttl: TTL = field(default_factory=TTL)
    compact_revision: int = 0
    # decayed op counters from the volume server's EWMA heat accounting
    # (stats/heat.py); old servers simply never report them
    read_heat: float = 0.0
    write_heat: float = 0.0
    # lifecycle signals: .dat lives on an S3-class remote backend, and how
    # many needles the background scrub flagged as CRC-corrupt
    remote_tier: bool = False
    corrupt_needles: int = 0

    @classmethod
    def from_heartbeat(cls, m: dict) -> "VolumeInfo":
        from ..storage.ttl import load_ttl_from_uint32

        return cls(
            id=m["id"],
            size=m.get("size", 0),
            collection=m.get("collection", ""),
            file_count=m.get("file_count", 0),
            delete_count=m.get("delete_count", 0),
            deleted_byte_count=m.get("deleted_byte_count", 0),
            read_only=m.get("read_only", False),
            replica_placement=ReplicaPlacement.from_byte(
                m.get("replica_placement", 0)
            ),
            version=m.get("version", 3),
            ttl=load_ttl_from_uint32(m.get("ttl", 0)),
            compact_revision=m.get("compact_revision", 0),
            read_heat=m.get("read_heat", 0.0),
            write_heat=m.get("write_heat", 0.0),
            remote_tier=m.get("remote_tier", False),
            corrupt_needles=m.get("corrupt_needles", 0),
        )


class Node:
    """Tree node with capacity counting (topology/node.go)."""

    def __init__(self, node_id: str):
        self.id = node_id
        self.children: dict[str, "Node"] = {}
        self.parent: Optional["Node"] = None
        self._max_volume_count = 0

    # capacity aggregates are recomputed on demand (simpler than the
    # reference's up-adjusting deltas; topologies are small)
    def max_volume_count(self) -> int:
        if not self.children:
            return self._max_volume_count
        return sum(c.max_volume_count() for c in self.children.values())

    def volume_count(self) -> int:
        if not self.children:
            return 0  # a leaf Rack/DC holds nothing; DataNode overrides
        return sum(c.volume_count() for c in self.children.values())

    def free_space(self) -> int:
        return self.max_volume_count() - self.volume_count()

    def is_data_node(self) -> bool:
        return False

    def get_or_create(self, node_id: str, factory) -> "Node":
        child = self.children.get(node_id)
        if child is None:
            child = factory(node_id)
            child.parent = self
            self.children[node_id] = child
        return child

    def pick_nodes_by_weight(
        self, count: int, filter_fn: Callable[["Node"], Optional[str]]
    ) -> tuple["Node", list["Node"]]:
        """Randomly pick `count` eligible children weighted by free space
        (node.go PickNodesByWeight): returns (main, others). Raises if fewer
        than count eligible."""
        candidates = []
        errs = []
        for c in self.children.values():
            err = filter_fn(c)
            if err is None:
                candidates.append(c)
            else:
                errs.append(f"{c.id}: {err}")
        if len(candidates) < count:
            raise NoFreeSpaceError(
                f"only {len(candidates)} of {len(self.children)} nodes eligible "
                f"under {self.id}, need {count}: " + "; ".join(errs[:5])
            )
        weights = [max(c.free_space(), 1) for c in candidates]
        picked: list[Node] = []
        pool = list(zip(candidates, weights))
        for _ in range(count):
            total = sum(w for _, w in pool)
            r = random.uniform(0, total)
            acc = 0.0
            for i, (c, w) in enumerate(pool):
                acc += w
                if r <= acc:
                    picked.append(c)
                    pool.pop(i)
                    break
        return picked[0], picked[1:]

    def reserve_one_volume(self) -> "DataNode":
        """Random free-space-weighted descent to a data node with a slot
        (node.go ReserveOneVolume)."""
        if self.is_data_node():
            if self.free_space() <= 0:
                raise NoFreeSpaceError(f"no slots on {self.id}")
            return self  # type: ignore[return-value]
        eligible = [c for c in self.children.values() if c.free_space() > 0]
        if not eligible:
            raise NoFreeSpaceError(f"no free slots under {self.id}")
        weights = [c.free_space() for c in eligible]
        chosen = random.choices(eligible, weights=weights)[0]
        return chosen.reserve_one_volume()


class NoFreeSpaceError(Exception):
    pass


class DataNode(Node):
    """One volume server (topology/data_node.go)."""

    def __init__(self, node_id: str):
        super().__init__(node_id)
        self.ip = ""
        self.port = 0
        self.public_url = ""
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, int] = {}  # vid → shard bit mask
        # lifecycle signals riding the EC heartbeat entries: decayed read
        # heat per EC volume and scrub-flagged corrupt shard ids on this node
        self.ec_read_heat: dict[int, float] = {}
        self.ec_corrupt: dict[int, list[int]] = {}
        # each EC volume's collection, as its entries name it: the autopilot
        # rebuilds and decodes by it (the JAX package's master keeps none, so
        # its autopilot cannot repair an EC volume of a named collection)
        self.ec_collections: dict[int, str] = {}
        self.last_seen = 0.0
        self.pulse_seconds = 5.0  # node-reported beat interval

    def is_data_node(self) -> bool:
        return True

    def url(self) -> str:
        return self.public_url or f"{self.ip}:{self.port}"

    def grpc_url(self) -> str:
        return f"{self.ip}:{self.port + 10000}"

    def volume_count(self) -> int:
        # derived from the volumes dict on demand: a cached count would
        # be one more field every sync/growth path must keep coherent
        # across the handler and background domains
        return len(self.volumes)

    def get_rack(self) -> "Rack":
        return self.parent  # type: ignore[return-value]

    def get_data_center(self) -> "DataCenter":
        return self.parent.parent  # type: ignore[return-value]


class Rack(Node):
    def new_data_node(
        self, node_id: str, ip: str, port: int, public_url: str, max_volumes: int
    ) -> DataNode:
        dn = self.get_or_create(node_id, DataNode)
        assert isinstance(dn, DataNode)
        dn.ip, dn.port, dn.public_url = ip, port, public_url
        dn._max_volume_count = max_volumes
        return dn


class DataCenter(Node):
    def get_or_create_rack(self, rack_id: str) -> Rack:
        r = self.get_or_create(rack_id, Rack)
        assert isinstance(r, Rack)
        return r


@instrument
class Topology(Node):
    def __init__(self, volume_size_limit: int = 30 * 1024 * 1024 * 1024):
        super().__init__("topo")
        self.volume_size_limit = volume_size_limit
        self._lock = make_rlock("Topology._lock")
        # (collection, rp_str, ttl_str) → VolumeLayout
        from .volume_layout import VolumeLayout

        self._VolumeLayout = VolumeLayout
        self.layouts: dict[tuple[str, str, str], "VolumeLayout"] = {}
        # vid → set of DataNode holding EC shards: vid → {shard_id → [nodes]}
        self.ec_shard_locations: dict[int, dict[int, list[DataNode]]] = {}
        self.max_volume_id = 0

    # -- tree building -------------------------------------------------------
    def get_or_create_data_center(self, dc_id: str) -> DataCenter:
        dc = self.get_or_create(dc_id, DataCenter)
        assert isinstance(dc, DataCenter)
        return dc

    def data_nodes(self) -> list[DataNode]:
        out = []
        for dc in self.children.values():
            for rack in dc.children.values():
                out.extend(
                    n for n in rack.children.values() if isinstance(n, DataNode)
                )
        return out

    # -- layouts -------------------------------------------------------------
    def get_volume_layout(
        self, collection: str, rp: ReplicaPlacement, ttl: TTL
    ) -> "VolumeLayout":
        key = (collection, str(rp), str(ttl))
        with self._lock:
            layout = self.layouts.get(key)
            if layout is None:
                layout = self._VolumeLayout(rp, ttl, self.volume_size_limit)
                self.layouts[key] = layout
            return layout

    def collection_names(self) -> list[str]:
        return sorted({k[0] for k in self.layouts if k[0]})

    def delete_collection(self, collection: str) -> list[int]:
        """Drop all layouts of a collection; returns affected vids."""
        with self._lock:
            vids = []
            for key in [k for k in self.layouts if k[0] == collection]:
                vids.extend(self.layouts[key].vid2location.keys())
                del self.layouts[key]
            return vids

    # -- heartbeat sync (topology.go:205-260) --------------------------------
    def sync_data_node_registration(
        self, dn: DataNode, volumes: list[dict]
    ) -> tuple[list[VolumeInfo], list[VolumeInfo]]:
        """Full heartbeat: replace dn's volume list. Returns (new, deleted)."""
        with self._lock:
            incoming = {m["id"]: VolumeInfo.from_heartbeat(m) for m in volumes}
            new_vis, deleted_vis = [], []
            for vid, vi in incoming.items():
                if vid not in dn.volumes:
                    new_vis.append(vi)
                self.max_volume_id = max(self.max_volume_id, vid)
            for vid, vi in dn.volumes.items():
                if vid not in incoming:
                    deleted_vis.append(vi)
            dn.volumes = incoming
            for vi in new_vis:
                self._register_volume(vi, dn)
            for vi in deleted_vis:
                self._unregister_volume(vi, dn)
            # refresh writability/size state for still-present volumes
            for vi in incoming.values():
                layout = self.get_volume_layout(
                    vi.collection, vi.replica_placement, vi.ttl
                )
                layout.ensure_correct_writables(vi)
            return new_vis, deleted_vis

    def incremental_sync(
        self, dn: DataNode, new_volumes: list[dict], deleted_volumes: list[dict]
    ) -> None:
        # deletions first (DeltaUpdateVolumes, topology.go): a volume
        # withdrawn and announced again in one beat, as a placement change
        # does, stays registered
        with self._lock:
            for m in deleted_volumes:
                vi = VolumeInfo.from_heartbeat(m)
                dn.volumes.pop(vi.id, None)
                self._unregister_volume(vi, dn)
            for m in new_volumes:
                vi = VolumeInfo.from_heartbeat(m)
                dn.volumes[vi.id] = vi
                self.max_volume_id = max(self.max_volume_id, vi.id)
                self._register_volume(vi, dn)

    def _register_volume(self, vi: VolumeInfo, dn: DataNode) -> None:
        layout = self.get_volume_layout(vi.collection, vi.replica_placement, vi.ttl)
        layout.register_volume(vi, dn)

    def _unregister_volume(self, vi: VolumeInfo, dn: DataNode) -> None:
        layout = self.get_volume_layout(vi.collection, vi.replica_placement, vi.ttl)
        layout.unregister_volume(vi, dn)

    def unregister_data_node(self, dn: DataNode) -> list[int]:
        """Node lost: mark its volumes unavailable. Returns affected vids."""
        with self._lock:
            affected = []
            for vi in dn.volumes.values():
                layout = self.get_volume_layout(
                    vi.collection, vi.replica_placement, vi.ttl
                )
                layout.set_volume_unavailable(vi.id, dn)
                affected.append(vi.id)
            for vid in list(dn.ec_shards):
                self.unregister_ec_shards(vid, dn)
                affected.append(vid)
            dn.volumes = {}
            dn.ec_shards = {}
            dn.ec_read_heat = {}
            dn.ec_corrupt = {}
            dn.ec_collections = {}
            if dn.parent:
                dn.parent.children.pop(dn.id, None)
            return affected

    # -- lookup --------------------------------------------------------------
    def lookup(self, collection: str, vid: int) -> list[DataNode]:
        with self._lock:
            if collection:
                keys = [k for k in self.layouts if k[0] == collection]
            else:
                keys = list(self.layouts)
            for key in keys:
                loc = self.layouts[key].vid2location.get(vid)
                if loc:
                    return list(loc)
            return []

    # -- EC shard registry (topology_ec.go:97-160) ---------------------------
    def sync_data_node_ec_shards(
        self, dn: DataNode, shards: list[dict]
    ) -> tuple[list[dict], list[dict]]:
        with self._lock:
            incoming: dict[int, int] = {}
            heat: dict[int, float] = {}
            corrupt: dict[int, set[int]] = {}
            collections: dict[int, str] = {}
            for s in shards:  # OR-merge: one entry per disk location
                vid = s["id"]
                incoming[vid] = incoming.get(vid, 0) | s.get("ec_index_bits", 0)
                collections[vid] = s.get("collection", "")
                h = s.get("read_heat", 0.0)
                if h > heat.get(vid, 0.0):
                    heat[vid] = h
                if s.get("corrupt_shards"):
                    corrupt.setdefault(vid, set()).update(s["corrupt_shards"])
            new_s, deleted_s = [], []
            for vid, bits in incoming.items():
                old = dn.ec_shards.get(vid, 0)
                if bits & ~old:
                    new_s.append({"id": vid, "ec_index_bits": bits & ~old})
            for vid, bits in dn.ec_shards.items():
                gone = bits & ~incoming.get(vid, 0)
                if gone:
                    deleted_s.append({"id": vid, "ec_index_bits": gone})
            # rebuild registry entries for this node
            for vid in set(dn.ec_shards) | set(incoming):
                self._set_ec_shards(vid, dn, incoming.get(vid, 0))
            dn.ec_shards = incoming
            dn.ec_read_heat = heat
            dn.ec_corrupt = {v: sorted(s) for v, s in corrupt.items()}
            dn.ec_collections = collections
            return new_s, deleted_s

    def _set_ec_shards(self, vid: int, dn: DataNode, bits: int) -> None:
        by_shard = self.ec_shard_locations.setdefault(vid, {})
        for sid in range(64):
            has = bool(bits & (1 << sid))
            nodes = by_shard.get(sid)
            if nodes is None:
                if not has:
                    continue
                nodes = by_shard.setdefault(sid, [])
            present = dn in nodes
            if has and not present:
                nodes.append(dn)
            elif not has and present:
                nodes.remove(dn)
            if not nodes:
                by_shard.pop(sid, None)
        if not by_shard:
            self.ec_shard_locations.pop(vid, None)

    def register_ec_shards(self, vid: int, dn: DataNode, bits: int,
                           collection: Optional[str] = None) -> None:
        with self._lock:
            self._set_ec_shards(vid, dn, dn.ec_shards.get(vid, 0) | bits)
            dn.ec_shards[vid] = dn.ec_shards.get(vid, 0) | bits
            if collection is not None:
                dn.ec_collections[vid] = collection

    def unregister_ec_shards(self, vid: int, dn: DataNode, bits: int = ~0) -> None:
        with self._lock:
            remaining = dn.ec_shards.get(vid, 0) & ~bits
            self._set_ec_shards(vid, dn, remaining)
            if remaining:
                dn.ec_shards[vid] = remaining
            else:
                dn.ec_shards.pop(vid, None)
                dn.ec_collections.pop(vid, None)

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        with self._lock:
            return {
                sid: list(nodes)
                for sid, nodes in self.ec_shard_locations.get(vid, {}).items()
                if nodes
            }

    def checkpoint_max_volume_id(self, vid: int) -> None:
        """Follower side: adopt the leader's volume-id high-water mark (it
        rides the leader's beats), so a failover never allocates a vid
        twice."""
        with self._lock:
            self.max_volume_id = max(self.max_volume_id, vid)

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id
