"""The shell's volume commands, cross-driven between the two packages.

A master, three volume servers and a shell, each of the JAX package or of
the port, run on loopback ports that rise with the servers' index, so a
server's rank in URL order is its index. Four pairings run one scenario:
all JAX (the reference), all port, the JAX shell over the port's master and
servers, and the port shell over the JAX master and servers. The scenario
lays the same volumes on the same servers (seeded needles with fixed append
times), then runs ``volume.vacuum``, ``volume.copy``, ``volume.unmount`` /
``volume.mount``, ``volume.configure.replication``,
``volume.fix.replication``, ``volume.move``, ``volume.balance -force``,
``ec.encode``, ``volumeServer.evacuate`` (its EC shards move too) and
``volumeServer.leave``. What each command answers, where each volume and
shard ends up and the sha256 of every file must be equal by server rank in
every pairing.

The balance planners of both packages (``_balance_plan`` by count and
``_heat_balance_plan`` by heat) must also give equal plans on seeded random
topologies. Exact equality everywhere; there is no tolerance.
"""

import contextlib
import hashlib
import os
import random
import socket
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.server.master_server import MasterServer as JMasterServer
from seaweedfs_tpu.server.volume_server import VolumeServer as JVolumeServer
from seaweedfs_tpu.shell import commands as jcommands
from seaweedfs_tpu.shell.commands import CommandEnv as JCommandEnv
from seaweedfs_tpu.shell.shell import run_command as j_run_command
from seaweedfs_tpu.storage.needle import Needle as JNeedle
from seaweedfs_tpu_torch.server.http_util import http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer as PMasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer as PVolumeServer
from seaweedfs_tpu_torch.shell import commands as pcommands
from seaweedfs_tpu_torch.shell.commands import CommandEnv as PCommandEnv
from seaweedfs_tpu_torch.shell.shell import run_command as p_run_command
from seaweedfs_tpu_torch.storage.needle import Needle as PNeedle

COL = "sv"
T0 = 1_700_000_000_000_000_000

# pairing id -> (master and servers, shell)
PAIRINGS = {
    "jax": ("jax", "jax"),
    "port": ("port", "port"),
    "jaxshell-portcluster": ("port", "jax"),
    "portshell-jaxcluster": ("jax", "port"),
}
_REFERENCE: dict = {}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rising_ports(n):
    while True:
        ports = sorted(_free_port() for _ in range(n))
        if len({len(str(p)) for p in ports}) == 1:
            return ports


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


@contextlib.contextmanager
def _cluster(kind, shell, tmp_path):
    mcls, vcls, backend, ncls = (
        (PMasterServer, PVolumeServer, "cpu", PNeedle) if kind == "port"
        else (JMasterServer, JVolumeServer, "numpy", JNeedle))
    master = mcls(port=_free_port(), node_timeout=60).start()
    servers = []
    try:
        for i, port in enumerate(_rising_ports(3)):
            servers.append(vcls([str(tmp_path / f"srv{i}")], port=port, master_url=master.url,
                                max_volume_count=8, pulse_seconds=0.3,
                                ec_backend=backend).start())
        env = (PCommandEnv if shell == "port" else JCommandEnv)(master.url)
        run = p_run_command if shell == "port" else j_run_command
        assert _wait(lambda: len(env.data_nodes()) == 3)
        yield master, servers, env, run, ncls
    finally:
        for s in servers:
            s.stop()
        if kind == "port":
            master.stop()
        else:
            # the JAX master's stop waits ~10 s on its loops: let it finish
            # beside the next test
            threading.Thread(target=master.stop, daemon=True).start()


def _put(srv, ncls, vid, first, count, seed, delete_every=0):
    """Seeded needles into ``vid`` on ``srv`` with fixed append times."""
    v = srv.store.find_volume(vid)
    rng = np.random.default_rng(seed)
    for i in range(first, first + count):
        v.write_needle(ncls(cookie=0x4400 + i, id=i,
                            data=rng.bytes(int(rng.integers(200, 60_000)))),
                       append_at_ns=T0 + seed * 10_000 + i)
    if delete_every:
        for i in range(first, first + count, delete_every):
            v.delete_needle(ncls(cookie=0x4400 + i, id=i),
                            append_at_ns=T0 + seed * 10_000 + 5000 + i)
    v.sync()


def _ranked(obj, rank):
    """``obj`` with every server URL replaced by its rank."""
    if isinstance(obj, dict):
        return {_ranked(k, rank): _ranked(v, rank) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_ranked(v, rank) for v in obj]
    if isinstance(obj, str):
        for url, r in rank.items():
            obj = obj.replace(url, f"<rank {r}>")
    return obj


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _disk(servers):
    """Per rank: {file name: sha256} of every volume and shard file."""
    out = []
    for s in servers:
        d = s.store.locations[0].directory
        out.append({name: _sha(os.path.join(d, name)) for name in sorted(os.listdir(d))
                    if name.endswith((".dat", ".idx", ".ecx", ".vif"))
                    or ".ec" in name})
    return out


def _scenario(master, servers, env, run, ncls):
    urls = [f"127.0.0.1:{s.port}" for s in servers]
    rank = {u: i for i, u in enumerate(urls)}
    out = {}

    def locs(vid):
        # from the servers' own /status: after a placement change the
        # master files the volume under a second layout, and its lookup may
        # name the first layout's holders only
        return sorted(rank[v["server"]] for v in env_volumes(env) if v["id"] == vid)

    def looked_up(vid):
        return sorted(rank[u] for u in env.volume_locations(vid))

    def settle(cond, what):
        assert _wait(cond), what

    # volumes 1-4 and 6 on rank 0, volume 5 on rank 1
    for vid, srv, seed in ((1, 0, 1), (2, 0, 2), (3, 0, 3), (4, 0, 4), (5, 1, 5), (6, 0, 6)):
        servers[srv].store.add_volume(vid, collection=COL)
        _put(servers[srv], ncls, vid, 1, 30, seed, delete_every=2 if vid == 1 else 0)
    settle(lambda: all(env.volume_locations(v) for v in range(1, 7)), "volumes announced")

    out["vacuum"] = run(env, "volume.vacuum -garbageThreshold=0.3")
    # volume 6 takes the replica commands; it is dropped afterwards, since a
    # placement change files it under a second layout of the master, whose
    # lookup then names the first layout's holders only
    out["copy"] = run(env, f"volume.copy -volumeId=6 -target={urls[1]}")
    settle(lambda: locs(6) == looked_up(6) == [0, 1], "the copy announced")
    out["unmount"] = run(env, f"volume.unmount -volumeId=6 -node={urls[1]}")
    settle(lambda: locs(6) == looked_up(6) == [0], "the unmount announced")
    out["mount"] = run(env, f"volume.mount -volumeId=6 -node={urls[1]}")
    settle(lambda: locs(6) == looked_up(6) == [0, 1], "the mount announced")
    out["configure"] = run(env, "volume.configure.replication -volumeId=6 -replication=002")
    settle(lambda: all(v["replica_placement"] == 2 for v in env_volumes(env) if v["id"] == 6),
           "the new placement announced")
    out["fix"] = run(env, "volume.fix.replication")
    settle(lambda: locs(6) == [0, 1, 2], "the fixed replica announced")
    out["volume6"] = _disk(servers)
    for u in urls:
        http_json("POST", f"http://{u}/admin/delete_volume?volume=6")
    settle(lambda: not locs(6), "volume 6 dropped")
    out["move"] = run(env, f"volume.move -volumeId=2 -target={urls[2]}")
    settle(lambda: locs(2) == looked_up(2) == [2], "the move announced")
    out["balance"] = run(env, "volume.balance -force=true")
    settle(lambda: all(len(locs(v)) == 1 and locs(v) == looked_up(v) for v in range(1, 6)),
           "balanced")
    out["locations"] = {vid: locs(vid) for vid in range(1, 6)}
    # seal volume 5 and spread its shards, then drain rank 2 and retire it
    out["ec_encode"] = run(env, f"ec.encode -volumeId=5 -collection={COL}")
    settle(lambda: len(env.ec_shard_locations(5)) == 14 and not locs(5),
           "the shards registered")
    out["evacuate"] = run(env, f"volumeServer.evacuate -node={urls[2]}")
    settle(lambda: all(rank[u] != 2 for us in env.ec_shard_locations(5).values() for u in us)
           and all(2 not in locs(v) for v in range(1, 5)), "the evacuation announced")
    out["leave"] = run(env, f"volumeServer.leave -node={urls[2]}")
    out["nodes_after_leave"] = sorted(rank[n["url"]] for n in env.data_nodes())
    out["final_locations"] = {vid: locs(vid) for vid in range(1, 5)}
    out["final_shards"] = {sid: sorted(rank[u] for u in us)
                           for sid, us in sorted(env.ec_shard_locations(5).items())}
    out["disk"] = _disk(servers)
    for name in ("vacuum", "copy", "unmount", "mount", "configure", "fix", "move",
                 "balance", "ec_encode", "evacuate", "leave", "locations"):
        out[name] = _ranked(out[name], rank)
    return out


def _with_kept_vif(ref_disk, got_disk):
    """The reference's files by rank, plus the ``.vif`` a port server keeps
    beside an ``.ecx`` where the JAX package's ``delete_volume`` removed it
    (the encode's source): a deliberate difference of the port."""
    out = []
    for want, got in zip(ref_disk, got_disk):
        kept = {name: sha for name, sha in got.items()
                if name.endswith(".vif") and name not in want
                and name[:-4] + ".ecx" in want}
        out.append(want | kept)
    return out


def env_volumes(env):
    """Every replica the registered servers report, with its server."""
    return [{**v, "server": n["url"]} for n in env.data_nodes()
            for v in env.node_status(n["url"]).get("volumes", [])]


@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_volume_commands_equal_by_rank(tmp_path, pairing):
    kind, shell = PAIRINGS[pairing]
    if "jax" not in _REFERENCE:
        with _cluster("jax", "jax", tmp_path / "ref") as c:
            _REFERENCE["jax"] = _scenario(*c)
    if pairing == "jax":
        got = _REFERENCE["jax"]
    else:
        with _cluster(kind, shell, tmp_path / "run") as c:
            got = _scenario(*c)
    ref = _REFERENCE["jax"]
    for key in ref:
        want = ref[key]
        if key == "disk" and kind == "port":
            want = _with_kept_vif(want, got[key])
            assert want != ref[key], "the encode's source kept its .vif"
        assert got[key] == want, key
    assert ref["vacuum"] == [1]
    assert ref["nodes_after_leave"] == [0, 1]
    assert len(ref["final_shards"]) == 14
    assert ref["evacuate"]["ec"] and ref["leave"] == {"left": "<rank 2>"}


def _topology(seed):
    """A seeded random cluster: nodes with capacities, volumes with replicas
    and heat, some in a second collection."""
    rng = random.Random(seed)
    nodes = [{"url": f"10.0.0.{i}:8080", "max": rng.randint(2, 12)}
             for i in range(rng.randint(2, 7))]
    volumes = []
    for vid in range(1, rng.randint(5, 40)):
        for n in rng.sample(nodes, rng.randint(1, min(3, len(nodes)))):
            volumes.append({"id": vid, "server": n["url"],
                            "collection": rng.choice(["", "", "pics"]),
                            "read_heat": rng.choice([0.0, rng.uniform(0, 50)]),
                            "write_heat": rng.uniform(0, 5)})
    volumes.append({"id": 999, "server": "10.9.9.9:1"})  # a node the master lost
    return volumes, nodes


@pytest.mark.parametrize("seed", range(12))
def test_balance_plans_equal(seed):
    volumes, nodes = _topology(seed)
    for collection in (None, "", "pics"):
        assert pcommands._balance_plan(volumes, nodes, collection) == \
            jcommands._balance_plan(volumes, nodes, collection)
    assert pcommands._heat_balance_plan(volumes, nodes) == \
        jcommands._heat_balance_plan(volumes, nodes)


def test_balance_plans_move_something():
    """The seeded topologies exercise the planners: some plans are not
    empty."""
    moves = heat = 0
    for seed in range(12):
        volumes, nodes = _topology(seed)
        moves += len(pcommands._balance_plan(volumes, nodes, None))
        heat += len(pcommands._heat_balance_plan(volumes, nodes))
    assert moves > 0 and heat > 0



def test_lookup_follows_a_placement_change(tmp_path):
    """A repair of the port: ``volume.configure.replication`` withdraws the
    volume from the master's layout of its old placement as it announces the
    new one (the reference's Go server unmounts and mounts it), so after
    ``volume.fix.replication`` and a ``volume.move`` the master's lookup
    names the holders. The JAX package's server only re-announces, and its
    master's lookup stays on the old layout's first holder."""
    seen = {}
    for kind in ("jax", "port"):
        with _cluster(kind, kind, tmp_path / kind) as (master, servers, env, run, ncls):
            urls = [f"127.0.0.1:{s.port}" for s in servers]
            rank = {u: i for i, u in enumerate(urls)}
            servers[0].store.add_volume(7, collection=COL)
            _put(servers[0], ncls, 7, 1, 10, 7)
            assert _wait(lambda: env.volume_locations(7))
            run(env, "volume.configure.replication -volumeId=7 -replication=001")
            run(env, "volume.fix.replication")
            assert _wait(lambda: len(env_volumes(env)) == 2)
            time.sleep(1.0)  # a few full beats
            fixed = sorted(rank[u] for u in env.volume_locations(7))
            http_json("POST", f"http://{urls[2]}/admin/volume_copy?volume=7"
                              f"&source={urls[0]}&collection={COL}")
            http_json("POST", f"http://{urls[0]}/admin/delete_volume?volume=7")
            assert _wait(lambda: sorted(rank[v["server"]] for v in env_volumes(env)) == [1, 2])
            time.sleep(1.0)
            seen[kind] = (fixed, sorted(rank[u] for u in env.volume_locations(7)))
    assert seen["port"] == ([0, 1], [1, 2])
    assert seen["jax"] == ([0], [0])  # the reference's stale lookup
