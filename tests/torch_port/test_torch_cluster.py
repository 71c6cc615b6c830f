"""The port's cluster plane (``seaweedfs_tpu_torch.cluster``) held against
the JAX package's.

The first part runs the JAX package's own cluster cases
(``tests/test_cluster.py``) on the port's ``Master``, ``Topology``,
``VolumeGrowth`` and ``MemorySequencer``. The last test feeds one seeded
trace to both packages' ``Master``: registrations over two data centers and
two racks each, full, delta and EC-delta heartbeats, assigns, grows,
lookups, a disconnect and a collection delete. Every result must be equal,
fids compared without their cookie (the master draws it from ``secrets``).
"""

import random

import pytest

from seaweedfs_tpu.cluster import volume_layout as j_layout
from seaweedfs_tpu.cluster.master import Master as JMaster
from seaweedfs_tpu.cluster.volume_growth import VolumeGrowOption as JGrowOption
from seaweedfs_tpu.storage.replica_placement import ReplicaPlacement as JRP
from seaweedfs_tpu_torch.cluster import volume_layout as p_layout
from seaweedfs_tpu_torch.cluster.master import Master
from seaweedfs_tpu_torch.cluster.sequence import MemorySequencer
from seaweedfs_tpu_torch.cluster.topology import NoFreeSpaceError, Topology
from seaweedfs_tpu_torch.cluster.volume_growth import (
    VolumeGrowOption,
    find_empty_slots_for_one_volume,
)
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.replica_placement import ReplicaPlacement


def build_topo(dcs=2, racks=2, nodes=3, slots=10):
    topo = Topology()
    for d in range(dcs):
        dc = topo.get_or_create_data_center(f"dc{d}")
        for r in range(racks):
            rack = dc.get_or_create_rack(f"rack{r}")
            for n in range(nodes):
                rack.new_data_node(
                    f"dc{d}-r{r}-n{n}:8080", f"10.{d}.{r}.{n}", 8080, "", slots
                )
    return topo


@pytest.mark.parametrize(
    "rp_str,expect_servers",
    [("000", 1), ("001", 2), ("010", 2), ("100", 2), ("011", 3), ("012", 4), ("112", 5)],
)
def test_placement_counts(rp_str, expect_servers):
    topo = build_topo()
    rp = ReplicaPlacement.from_string(rp_str)
    servers = find_empty_slots_for_one_volume(
        topo, VolumeGrowOption(replica_placement=rp)
    )
    assert len(servers) == expect_servers
    assert len({s.id for s in servers}) == expect_servers  # all distinct
    # placement constraints
    dcs = {s.get_data_center().id for s in servers}
    racks = {(s.get_data_center().id, s.get_rack().id) for s in servers}
    assert len(dcs) == rp.diff_data_center_count + 1
    assert len(racks) >= rp.diff_rack_count + 1


def test_placement_insufficient_topology():
    topo = build_topo(dcs=1)
    rp = ReplicaPlacement.from_string("100")  # needs 2 DCs
    with pytest.raises(NoFreeSpaceError):
        find_empty_slots_for_one_volume(topo, VolumeGrowOption(replica_placement=rp))


def test_placement_preferred_data_center():
    topo = build_topo()
    servers = find_empty_slots_for_one_volume(
        topo,
        VolumeGrowOption(
            replica_placement=ReplicaPlacement.from_string("001"),
            data_center="dc1",
        ),
    )
    assert all(s.get_data_center().id == "dc1" for s in servers)


def make_master(**kw):
    """Master with an in-memory allocate callback (no real volume servers)."""
    allocations = []

    def allocate(dn, vid, option):
        allocations.append((dn.id, vid, option.collection))

    m = Master(allocate_volume=allocate, **kw)
    m._allocations = allocations
    return m


def test_master_assign_and_lookup():
    m = make_master()
    for i in range(6):
        m.register_data_node(f"10.0.0.{i}", 8080, max_volume_count=20)
    res = m.assign(count=1, replication="001")
    fid = FileId.parse(res.fid)
    assert fid.volume_id >= 1
    assert res.url
    assert len(res.replicas) == 1  # 001 → one extra replica
    locs = m.lookup_volume(fid.volume_id)
    assert len(locs) == 2
    # volumes were "allocated" on servers
    assert len(m._allocations) >= 2


def test_master_assign_distinct_fids_and_cookie():
    m = make_master()
    m.register_data_node("10.0.0.1", 8080, max_volume_count=50)
    fids = {m.assign().fid for _ in range(20)}
    assert len(fids) == 20


def test_master_heartbeat_full_and_delta():
    m = make_master()
    dn = m.register_data_node("10.0.0.1", 8080, max_volume_count=10)
    events = []
    m.subscribe("test", events.append)

    hb = {
        "max_file_key": 500,
        "volumes": [
            {"id": 1, "size": 100, "replica_placement": 0},
            {"id": 2, "size": 200, "replica_placement": 0},
        ],
    }
    m.handle_heartbeat(dn, hb)
    assert m.sequencer.peek() > 500
    assert len(m.lookup_volume(1)) == 1
    assert {e["vid"] for e in events if not e["deleted"]} == {1, 2}

    # delta: volume 3 added, volume 1 gone (next full heartbeat)
    m.handle_heartbeat(dn, {"new_volumes": [{"id": 3, "replica_placement": 0}]})
    assert len(m.lookup_volume(3)) == 1
    m.handle_heartbeat(dn, {"volumes": [{"id": 2, "replica_placement": 0},
                                        {"id": 3, "replica_placement": 0}]})
    assert m.lookup_volume(1) == []
    assert any(e["vid"] == 1 and e["deleted"] for e in events)


def test_master_node_disconnect():
    m = make_master()
    dn = m.register_data_node("10.0.0.1", 8080)
    m.handle_heartbeat(dn, {"volumes": [{"id": 7, "replica_placement": 0}]})
    assert m.lookup_volume(7)
    m.handle_node_disconnect(dn)
    assert m.lookup_volume(7) == []
    # writables must be empty → assign grows new volumes on remaining nodes
    m.register_data_node("10.0.0.2", 8080, max_volume_count=10)
    res = m.assign()
    assert res.url.startswith("10.0.0.2")


def test_master_ec_shard_sync_and_lookup():
    m = make_master()
    dn1 = m.register_data_node("10.0.0.1", 8080)
    dn2 = m.register_data_node("10.0.0.2", 8080)
    m.handle_heartbeat(dn1, {"ec_shards": [{"id": 9, "ec_index_bits": 0b0000011111}]})
    m.handle_heartbeat(dn2, {"ec_shards": [{"id": 9, "ec_index_bits": 0b1111100000}]})
    ec = m.lookup_ec_volume(9)
    assert set(ec["shard_id_locations"]) == set(range(10))
    assert ec["shard_id_locations"][0] == ["10.0.0.1:8080"]
    assert ec["shard_id_locations"][9] == ["10.0.0.2:8080"]
    # plain lookup falls back to EC locations
    urls = {l["url"] for l in m.lookup_volume(9)}
    assert urls == {"10.0.0.1:8080", "10.0.0.2:8080"}
    # shard moves away on next ec heartbeat
    m.handle_heartbeat(dn1, {"ec_shards": []})
    ec = m.lookup_ec_volume(9)
    assert set(ec["shard_id_locations"]) == set(range(5, 10))


def test_node_disconnect_with_ec_shards():
    """Regression: popping dn.ec_shards while iterating must not crash."""
    m = make_master()
    dn1 = m.register_data_node("10.0.0.1", 8080)
    dn2 = m.register_data_node("10.0.0.2", 8080)
    m.handle_heartbeat(dn1, {"ec_shards": [{"id": 9, "ec_index_bits": 0b11111}]})
    m.handle_heartbeat(dn2, {"ec_shards": [{"id": 9, "ec_index_bits": 0b1111100000}]})
    m.handle_node_disconnect(dn1)
    ec = m.lookup_ec_volume(9)
    assert set(ec["shard_id_locations"]) == set(range(5, 10))
    # fully unregister node 2 as well → registry entry pruned entirely
    m.handle_node_disconnect(dn2)
    assert m.topo.ec_shard_locations == {}


def test_ec_heartbeat_multi_location_or_merge():
    """Two disk locations of one server reporting the same EC volume must
    OR-merge, not last-wins."""
    m = make_master()
    dn = m.register_data_node("10.0.0.1", 8080)
    m.handle_heartbeat(
        dn,
        {"ec_shards": [
            {"id": 4, "ec_index_bits": 0b0011},
            {"id": 4, "ec_index_bits": 0b1100},
        ]},
    )
    ec = m.lookup_ec_volume(4)
    assert set(ec["shard_id_locations"]) == {0, 1, 2, 3}


def test_oversized_volume_recovers_after_shrink():
    m = make_master()
    dn = m.register_data_node("10.0.0.1", 8080)
    big = m.topo.volume_size_limit + 1
    m.handle_heartbeat(dn, {"volumes": [{"id": 1, "size": big, "replica_placement": 0}]})
    layout = next(iter(m.topo.layouts.values()))
    assert 1 not in layout.writables
    # vacuum shrank it; next heartbeat reports small size
    m.handle_heartbeat(dn, {"volumes": [{"id": 1, "size": 100, "replica_placement": 0}]})
    assert 1 in layout.writables


def test_admin_lock():
    m = make_master()
    token = m.lease_admin_token("shell-1")
    with pytest.raises(RuntimeError, match="admin lock"):
        m.lease_admin_token("shell-2")
    # renewal with previous token works
    assert m.lease_admin_token("shell-1", previous_token=token) == token
    m.release_admin_token(token)
    assert m.lease_admin_token("shell-2")


def test_collections():
    m = make_master()
    m.register_data_node("10.0.0.1", 8080, max_volume_count=30)
    m.assign(collection="photos")
    m.assign(collection="logs")
    assert m.collection_list() == ["logs", "photos"]
    vids = m.collection_delete("photos")
    assert vids
    assert m.collection_list() == ["logs"]


def test_vacuum_orchestration():
    m = make_master(garbage_threshold=0.3)
    dn = m.register_data_node("10.0.0.1", 8080)
    m.handle_heartbeat(dn, {"volumes": [{"id": 1, "replica_placement": 0},
                                        {"id": 2, "replica_placement": 0}]})
    garbage = {1: 0.6, 2: 0.1}
    compacted_calls = []

    def check(dn_, vid):
        return garbage[vid]

    def compact(dn_, vid):
        compacted_calls.append(vid)
        return True

    assert m.vacuum(check, compact) == [1]
    assert compacted_calls == [1]


def test_sequencer_monotonic_and_batch():
    m = make_master()
    assert isinstance(m.sequencer, MemorySequencer)
    a = m.sequencer.next_file_id(10)
    b = m.sequencer.next_file_id(1)
    assert b == a + 10
    m.sequencer.set_max(1000)
    assert m.sequencer.next_file_id() == 1001


# -- one seeded trace through both packages' Master ---------------------------
def _fid_key(fid: str) -> tuple[int, int]:
    f = FileId.parse(fid)
    return f.volume_id, f.key


def _trace(master_cls, grow_option, rp_cls, layout_mod, seed: int) -> list:
    """Drive one Master through the trace; returns every observable result.
    The placement draws come from the process-global ``random`` (topology)
    and the layout module's ``_rng``: both are seeded here."""
    random.seed(seed)
    layout_mod.seed_placement(seed + 1)
    allocations = []
    m = master_cls(
        volume_size_limit=64 << 20,
        allocate_volume=lambda dn, vid, opt: allocations.append(
            (dn.id, vid, opt.collection, str(opt.replica_placement))),
    )
    events = []
    m.subscribe("trace", lambda e: events.append(
        (e["vid"], e["url"], e["deleted"])))
    out = []
    nodes = {}
    for d in range(2):
        for r in range(2):
            for n in range(2):
                ip = f"10.{d}.{r}.{n}"
                nodes[ip] = m.register_data_node(
                    ip, 8080, data_center=f"dc{d}", rack=f"rack{r}",
                    max_volume_count=12)
    ips = sorted(nodes)
    # full beats: two plain volumes on the first node of each rack, one hot
    for i, ip in enumerate(ips[::2]):
        vols = [{"id": 100 + 2 * i + j, "size": 1000 * (j + 1),
                 "collection": "pics", "replica_placement": 0,
                 "read_heat": 50.0 * j, "file_count": 3}
                for j in range(2)]
        out.append(m.handle_heartbeat(nodes[ip], {"max_file_key": 40 + i,
                                                  "volumes": vols}))
    out.append(m.sequencer.peek())
    # assigns across replications and collections: each grows and picks
    for rep, col in [("000", "pics"), ("001", ""), ("010", "docs"),
                     ("100", "docs"), ("000", "pics"), ("001", ""),
                     ("011", "logs"), ("000", "pics")]:
        for count in (1, 5):
            a = m.assign(count=count, replication=rep, collection=col)
            out.append((_fid_key(a.fid), a.url, a.public_url, a.count,
                        a.replicas))
    # /vol/grow
    opt = grow_option(collection="grown",
                      replica_placement=rp_cls.from_string("010"))
    out.append(m.vg.grow_by_count(m.topo, opt, 3))
    # delta beats: a volume appears, another goes
    out.append(m.handle_heartbeat(nodes[ips[1]], {
        "new_volumes": [{"id": 300, "collection": "pics", "replica_placement": 0}]}))
    out.append(m.handle_heartbeat(nodes[ips[0]], {
        "deleted_volumes": [{"id": 100, "collection": "pics", "replica_placement": 0}]}))
    # EC: a full EC beat on two nodes, then EC deltas
    out.append(m.handle_heartbeat(nodes[ips[2]], {"ec_shards": [
        {"id": 500, "collection": "warm", "ec_index_bits": 0b00000001111111}]}))
    out.append(m.handle_heartbeat(nodes[ips[5]], {"ec_shards": [
        {"id": 500, "collection": "warm", "ec_index_bits": 0b11111110000000}]}))
    out.append(m.handle_heartbeat(nodes[ips[6]], {
        "new_ec_shards": [{"id": 500, "ec_index_bits": 0b1}]}))
    out.append(m.handle_heartbeat(nodes[ips[5]], {
        "deleted_ec_shards": [{"id": 500, "ec_index_bits": 0b110000000}]}))
    for vid in (100, 101, 102, 300, 500, 999):
        out.append(("lookup", vid, m.lookup_volume(vid)))
        out.append(("lookup_ec", vid, m.lookup_ec_volume(vid)))
    out.append(m.topology_info())
    # a node dies; assigns route around it
    m.handle_node_disconnect(nodes[ips[2]])
    out.append(m.lookup_ec_volume(500))
    for rep in ("000", "001", "010"):
        a = m.assign(replication=rep, collection="after")
        out.append((_fid_key(a.fid), a.url, a.replicas))
    out.append(sorted(m.collection_delete("docs")))
    out.append(m.collection_list())
    out.append(m.topology_info())
    out.append(m.location_deltas(0))
    out.append(allocations)
    out.append(events)
    return out


@pytest.mark.parametrize("seed", [3, 17, 2024])
def test_port_master_matches_jax_master_on_a_seeded_trace(seed):
    want = _trace(JMaster, JGrowOption, JRP, j_layout, seed)
    got = _trace(Master, VolumeGrowOption, ReplicaPlacement, p_layout, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
