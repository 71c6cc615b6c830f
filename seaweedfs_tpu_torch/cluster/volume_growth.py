"""VolumeGrowth: pick servers for new volumes honoring xyz replica placement.

Mirrors `weed/topology/volume_growth.go:113` (findEmptySlotsForOneVolume):
pick DiffDataCenterCount+1 data centers (weighted random, each must have
enough racks/slots), then DiffRackCount+1 racks in the main DC, then
SameRackCount+1 servers in the main rack, then one free server in each other
rack/DC. Allocation on the chosen servers goes through an injected
`allocate_volume` callback (gRPC in the daemon, in-process in tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import TTL, EMPTY_TTL
from .topology import DataCenter, DataNode, NoFreeSpaceError, Rack, Topology


@dataclass
class VolumeGrowOption:
    collection: str = ""
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=lambda: EMPTY_TTL)
    preallocate: int = 0
    data_center: str = ""
    rack: str = ""
    data_node: str = ""


# allocate_volume(dn, vid, option) — raises on failure
AllocateVolumeFn = Callable[[DataNode, int, VolumeGrowOption], None]


def find_empty_slots_for_one_volume(
    topo: Topology, option: VolumeGrowOption
) -> list[DataNode]:
    rp = option.replica_placement

    def dc_filter(node) -> Optional[str]:
        if option.data_center and isinstance(node, DataCenter) and node.id != option.data_center:
            return f"not preferred dc {option.data_center}"
        if len(node.children) < rp.diff_rack_count + 1:
            return f"only {len(node.children)} racks"
        if node.free_space() < rp.diff_rack_count + rp.same_rack_count + 1:
            return f"free {node.free_space()} too low"
        possible_racks = 0
        for rack in node.children.values():
            free_nodes = sum(1 for n in rack.children.values() if n.free_space() >= 1)
            if free_nodes >= rp.same_rack_count + 1:
                possible_racks += 1
        if possible_racks < rp.diff_rack_count + 1:
            return f"only {possible_racks} usable racks"
        return None

    main_dc, other_dcs = topo.pick_nodes_by_weight(
        rp.diff_data_center_count + 1, dc_filter
    )

    def rack_filter(node) -> Optional[str]:
        if option.rack and isinstance(node, Rack) and node.id != option.rack:
            return f"not preferred rack {option.rack}"
        if node.free_space() < rp.same_rack_count + 1:
            return "not enough free slots"
        if len(node.children) < rp.same_rack_count + 1:
            return "not enough data nodes"
        free_nodes = sum(1 for n in node.children.values() if n.free_space() >= 1)
        if free_nodes < rp.same_rack_count + 1:
            return "not enough free data nodes"
        return None

    main_rack, other_racks = main_dc.pick_nodes_by_weight(
        rp.diff_rack_count + 1, rack_filter
    )

    def server_filter(node) -> Optional[str]:
        if option.data_node and node.is_data_node() and node.id != option.data_node:
            return f"not preferred node {option.data_node}"
        if node.free_space() < 1:
            return "no free slots"
        return None

    main_server, other_servers = main_rack.pick_nodes_by_weight(
        rp.same_rack_count + 1, server_filter
    )

    servers: list[DataNode] = [main_server]  # type: ignore[list-item]
    servers.extend(other_servers)  # type: ignore[arg-type]
    for rack in other_racks:
        servers.append(rack.reserve_one_volume())
    for dc in other_dcs:
        servers.append(dc.reserve_one_volume())
    return servers


class VolumeGrowth:
    def __init__(self, allocate_volume: AllocateVolumeFn, on_register=None):
        self.allocate_volume = allocate_volume
        # called (vid, DataNode) after each successful placement so the
        # master can push the new location to KeepConnected subscribers
        self.on_register = on_register

    def grow_by_count(
        self, topo: Topology, option: VolumeGrowOption, count: int = 1
    ) -> int:
        """Grow up to `count` volumes; returns how many were created
        (GrowByCountAndType, volume_growth.go:88). Partial growth is success
        — the error is re-raised only when nothing could be grown, matching
        the assign flow where any new writable volume unblocks the client."""
        grown = 0
        for _ in range(count):
            try:
                servers = find_empty_slots_for_one_volume(topo, option)
            except NoFreeSpaceError:
                if grown == 0:
                    raise
                break
            vid = topo.next_volume_id()
            self._grow_one(topo, vid, option, servers)
            grown += 1
        return grown

    def _grow_one(
        self,
        topo: Topology,
        vid: int,
        option: VolumeGrowOption,
        servers: list[DataNode],
    ) -> None:
        from .topology import VolumeInfo

        for server in servers:
            self.allocate_volume(server, vid, option)
            vi = VolumeInfo(
                id=vid,
                collection=option.collection,
                replica_placement=option.replica_placement,
                ttl=option.ttl,
                version=3,
            )
            # the heartbeat sync paths mutate server.volumes and the
            # layouts under topo._lock (an RLock) from the background
            # domain; growth runs on a handler thread, so it must take
            # the same lock or a full sync can interleave mid-register
            with topo._lock:
                server.volumes[vid] = vi
                topo._register_volume(vi, server)
            if self.on_register is not None:
                self.on_register(vid, server)

    @staticmethod
    def default_grow_count(rp: ReplicaPlacement) -> int:
        """How many volumes to grow per automatic growth
        (master_server_handlers.go / vg growth defaults by copy count)."""
        copy_count = rp.copy_count()
        if copy_count == 1:
            return 7
        if copy_count == 2:
            return 6
        if copy_count == 3:
            return 3
        return 1
