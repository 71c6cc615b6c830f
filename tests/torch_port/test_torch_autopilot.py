"""The port's autopilot on a port-only cluster with the CPU backend: the
master's lifecycle controller drives EC, repair and the cold tier with no
operator command (the JAX package's ``tests/test_lifecycle_chaos.py`` and
its scrub-to-repair test).

In process, the master's ``lifecycle.tick()`` runs cycle by cycle over live
volume servers (``SWEED_TURBO=0``: the native engine marks no heat, as in
the JAX package). Each volume's heat counters get a short half-life, so a
volume cools in a second or two:

- a cooling volume is fleet-EC'd exactly once (one ``/admin/ec/generate``);
- a byte flipped in a shard reaches the master through the scrub, and the
  autopilot drops the shard and rebuilds it (sha256 equal to the .vif's);
- a cold volume moves to the in-repo fake S3; reads through the tier warm
  it, and the autopilot brings it back.

In subprocesses, the kill-master matrix: a child runs a persistent cluster
(a master with ``meta_dir`` and two volume servers) and ticks the
controller; a fault armed at a plan-journal window kills it
(``os._exit(113)``); a second child over the same state replays the journal.
Every seeded volume ends EC'd, generated exactly once over both runs, and
every needle reads back byte-equal. A restarted master takes a fresh port
and its state files, which are named by the port, go with it.
"""

import collections
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu_torch.ec.constants import shard_ext
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell.commands import CommandEnv, ec_encode
from seaweedfs_tpu_torch.storage.backend.fake_s3 import FakeS3Server
from seaweedfs_tpu_torch.storage.volume import volume_file_name
from seaweedfs_tpu_torch.util import faultpoints

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIFECYCLE_ENV = ("SWEED_FAULTPOINTS", "SWEED_LIFECYCLE", "SWEED_TIER_ENDPOINT", "SWEED_SCRUB",
                 "SWEED_LIFECYCLE_BUDGETS", "SWEED_HEAT_FLOOR", "SWEED_TIER_FLOOR",
                 "SWEED_HEAT_CEILING")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def wait_until(pred, timeout=30.0, interval=0.1, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


class Cluster:
    """A port master (its controller ticked by hand) and ``n`` port volume
    servers on the CPU backend. ``generates`` lists the volume of every
    ``/admin/ec/generate`` the servers answered."""

    def __init__(self, tmp_path, monkeypatch, n=2, scrub=False):
        monkeypatch.setenv("SWEED_TURBO", "0")
        for var in LIFECYCLE_ENV:
            monkeypatch.delenv(var, raising=False)
        if scrub:
            monkeypatch.setenv("SWEED_SCRUB", "1")
        monkeypatch.setenv("SWEED_LIFECYCLE_COLD_STREAK", "2")
        monkeypatch.setenv("SWEED_LIFECYCLE_COOLDOWN", "1")
        self.generates = []
        generate = VolumeServer._h_ec_generate

        def counted(vs, h, path, q, body):
            self.generates.append(int(q.get("volume", 0)))
            return generate(vs, h, path, q, body)

        monkeypatch.setattr(VolumeServer, "_h_ec_generate", counted)
        self.master = MasterServer(port=free_port(), node_timeout=60).start()
        self.dirs = [str(tmp_path / f"v{i}") for i in range(n)]
        self.servers = [VolumeServer([d], port=free_port(), master_url=self.master.url,
                                     max_volume_count=10, pulse_seconds=0.2,
                                     ec_backend="cpu").start() for d in self.dirs]
        wait_until(lambda: len(self.master.master.topo.data_nodes()) == n, what="servers")
        self.env = CommandEnv(self.master.url)

    def fill(self, collection, n, size=3000, halflife=0.2):
        """A volume of its own grown in ``collection``, ``n`` needles; its
        heat counters then halve every ``halflife`` seconds."""
        assert http_json("POST", f"http://{self.master.url}/vol/grow?collection={collection}"
                                 "&count=1") == {"count": 1}
        blobs = {}
        for i in range(n):
            a = http_json("POST", f"http://{self.master.url}/dir/assign?collection={collection}")
            data = hashlib.sha256(f"{collection}{i}".encode()).digest() * (size // 32 + i)
            assert http_bytes("POST", f"http://{a['url']}/{a['fid']}", data)[0] == 201
            blobs[a["fid"]] = data
        vid = int(next(iter(blobs)).split(",")[0])
        assert all(int(f.split(",")[0]) == vid for f in blobs)
        for vs in self.servers:
            v = vs.store.find_volume(vid)
            if v is not None:
                v.read_heat.halflife = v.write_heat.halflife = halflife
        return vid, blobs

    def read(self, fid):
        vid = fid.split(",")[0]
        r = http_json("GET", f"http://{self.master.url}/dir/lookup?volumeId={vid}")
        for loc in r.get("locations", []):
            status, data = http_bytes("GET", f"http://{loc['url']}/{fid}")
            if status == 200:
                return data
        return None

    def tick_until(self, kind, vid, timeout=30.0):
        """Tick the controller until a ``kind`` action on ``vid`` is done;
        every action that reached done or failed on the way."""
        seen = []

        def step():
            s = self.master.lifecycle.tick()
            seen.extend((a["kind"], a["vid"], a["state"]) for a in s["actions"]
                        if a["state"] in ("done", "failed"))
            return (kind, vid, "done") in seen

        wait_until(step, timeout=timeout, interval=0.25,
                   what=f"{kind} of volume {vid} (so far {seen[-6:]})")
        return seen

    def node(self, url):
        return next(dn for dn in self.master.master.topo.data_nodes() if dn.url() == url)

    def stop(self):
        for vs in self.servers:
            vs.stop()
        self.master.stop()


def test_cooling_volume_ecs_exactly_once(tmp_path, monkeypatch):
    c = Cluster(tmp_path, monkeypatch)
    try:
        vid, blobs = c.fill("cool", 12)
        seen = c.tick_until("ec", vid)
        for _ in range(6):  # the volume is EC now: no cycle encodes it again
            seen += [(a["kind"], a["vid"], a["state"]) for a in c.master.lifecycle.tick()
                     ["actions"]]
            time.sleep(0.2)
        assert [a for a in seen if a[1] == vid] == [("ec", vid, "done")]
        assert c.generates == [vid]
        wait_until(lambda: len(c.env.ec_shard_locations(vid)) == 14, what="14 shards")
        assert c.master.master.topo.lookup("cool", vid) == []
        for fid, data in blobs.items():
            assert c.read(fid) == data
    finally:
        c.stop()


def test_flipped_shard_repaired_by_the_autopilot(tmp_path, monkeypatch):
    """A byte flipped in a shard on disk: the scrub hashes it against the
    .vif, the heartbeat carries the finding, and the autopilot's
    repair_shard drops the shard and rebuilds it. No operator action
    between the flip and the repair."""
    c = Cluster(tmp_path, monkeypatch, n=3, scrub=True)
    try:
        vid, blobs = c.fill("rep", 16, halflife=60.0)  # warm: nothing but the repair
        ec_encode(c.env, vid, "rep")
        wait_until(lambda: len(c.env.ec_shard_locations(vid)) == 14, what="14 shards")
        holder, sid = next((vs, sid) for vs in c.servers for sid in sorted(
            vs.store.find_ec_volume(vid).shard_ids() if vs.store.find_ec_volume(vid) else [])
            if os.path.exists(volume_file_name(vs.store.locations[0].directory, "rep", vid)
                              + ".vif"))
        base = volume_file_name(holder.store.locations[0].directory, "rep", vid)
        with open(base + ".vif") as f:
            want = json.load(f)["shard_sums"][sid]
        with open(base + shard_ext(sid), "r+b") as f:
            f.seek(128)
            b = f.read(1)
            f.seek(128)
            f.write(bytes([b[0] ^ 0x5A]))
        url = f"127.0.0.1:{holder.port}"
        wait_until(lambda: sid in c.node(url).ec_corrupt.get(vid, []), timeout=60,
                   what="the scrub's finding at the master")
        seen = c.tick_until("repair_shard", vid, timeout=60)
        assert ("repair_shard", vid, "done") in seen
        wait_until(lambda: not any(dn.ec_corrupt.get(vid)
                                   for dn in c.master.master.topo.data_nodes()),
                   what="the finding cleared")
        rebuilt = [volume_file_name(vs.store.locations[0].directory, "rep", vid) + shard_ext(sid)
                   for vs in c.servers]
        rebuilt = [p for p in rebuilt if os.path.exists(p)]
        assert rebuilt
        for p in rebuilt:
            with open(p, "rb") as f:
                assert hashlib.sha256(f.read()).hexdigest() == want
        for fid, data in blobs.items():
            assert c.read(fid) == data
        assert c.master.lifecycle.status()["counters"]["actions_done"] >= 1
    finally:
        c.stop()


def test_cold_volume_tiers_and_comes_back_when_read(tmp_path, monkeypatch):
    """Cold -> tier_up to the fake S3 (the .dat leaves the disk, reads go
    through ranged GETs); a burst of reads warms it -> tier_down."""
    c = Cluster(tmp_path, monkeypatch)
    # no cool band: a volume cooling past the floor is cold at once, and
    # tiers instead of taking the EC on the way down
    monkeypatch.setenv("SWEED_TIER_FLOOR", "0.05")
    try:
        with FakeS3Server(str(tmp_path / "s3")) as s3:
            c.master.lifecycle.cfg.tier_endpoint = s3.endpoint  # the ops share the config
            vid, blobs = c.fill("cold", 10, halflife=0.2)
            seen = c.tick_until("tier_up", vid)
            assert ("ec", vid, "done") not in seen
            holder = next(vs for vs in c.servers if vs.store.find_volume(vid))
            v = holder.store.find_volume(vid)
            assert v.is_tiered() and not os.path.exists(v.file_name() + ".dat")
            assert os.path.getsize(s3.object_path("sweed-cold", f"cold_{vid}.dat")) == v.size()
            wait_until(lambda: c.master.master.topo.lookup("cold", vid)
                       and c.node(f"127.0.0.1:{holder.port}").volumes[vid].remote_tier,
                       what="the tier flag at the master")
            gets = len(s3.ranged_gets)
            for fid, data in blobs.items():  # the read burst, through the tier
                assert c.read(fid) == data
            assert len(s3.ranged_gets) >= gets + len(blobs)
            seen = c.tick_until("tier_down", vid)
            assert not v.is_tiered() and os.path.exists(v.file_name() + ".dat")
            for fid, data in blobs.items():
                assert c.read(fid) == data
    finally:
        c.stop()


# -- the kill-master matrix (subprocess per run) -------------------------------

CHILD = r"""
import hashlib, json, os, socket, sys, time

statedir, op = sys.argv[1], sys.argv[2]
faultspec = sys.argv[3] if len(sys.argv) > 3 else ""

from seaweedfs_tpu_torch.cluster.lifecycle import observe_topology
from seaweedfs_tpu_torch.server.http_util import http_bytes, http_json
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.util import faultpoints

# a relaunch takes a fresh port (another test may hold the old one by now)
# and carries the master's state files, named by its port, over to it
meta = os.path.join(statedir, "meta")
port_file = os.path.join(statedir, "master_port")
sock = socket.socket()
sock.bind(("127.0.0.1", 0))
port = sock.getsockname()[1]
sock.close()
if os.path.exists(port_file):
    old = open(port_file).read()
    for name in os.listdir(meta):
        stem, _, ext = name.rpartition("_" + old + ".")
        if stem:
            os.replace(os.path.join(meta, name), os.path.join(meta, f"{stem}_{port}.{ext}"))
open(port_file, "w").write(str(port))
master = MasterServer(port=port, node_timeout=60, meta_dir=meta).start()

generate = VolumeServer._h_ec_generate
def counted(vs, h, path, q, body):
    with open(os.path.join(statedir, "generates"), "a") as f:
        f.write(q.get("volume", "") + "\n")
    return generate(vs, h, path, q, body)
VolumeServer._h_ec_generate = counted

vservers = []
for k in ("v0", "v1"):
    d = os.path.join(statedir, "vol_" + k)
    os.makedirs(d, exist_ok=True)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    vport = sock.getsockname()[1]
    sock.close()
    vservers.append(VolumeServer([d], port=vport, master_url=master.url, max_volume_count=20,
                                 pulse_seconds=0.3, ec_backend="cpu").start())
while len(master.master.topo.data_nodes()) < 2:
    time.sleep(0.05)
lc = master.lifecycle
expected_file = os.path.join(statedir, "expected.json")


def read_fid(fid):
    r = http_json("GET", "http://%s/dir/lookup?volumeId=%s" % (master.url, fid.split(",")[0]))
    for loc in r.get("locations", []):
        s, data = http_bytes("GET", "http://%s/%s" % (loc["url"], fid))
        if s == 200:
            return data
    return None


def run_ticks(max_ticks=40):
    # cycles until two quiet ones in a row; an armed journal fault kills
    # the process somewhere inside a tick
    executed, quiet = [], 0
    for _ in range(max_ticks):
        s = lc.tick()
        executed += [(a["kind"], a["vid"], a["state"]) for a in s["actions"]
                     if a["state"] in ("done", "failed")]
        quiet = quiet + 1 if not s["actions"] else 0
        if quiet >= 2:
            return executed
        time.sleep(0.4)
    raise SystemExit("lifecycle never quiesced: %r" % (executed,))


def check_converged():
    time.sleep(1.0)  # the delta beats of the last move land
    obs = observe_topology(master)
    torn = {v: ob for v, ob in obs.items() if ob["replicas"] and ob["ec_shards"]}
    assert not torn, "torn plain+EC state: %r" % (torn,)
    expected = json.load(open(expected_file))
    seeded = {int(fid.split(",")[0]) for fid in expected}
    assert seeded <= {v for v, ob in obs.items() if ob["kind"] == "ec"}, obs
    bad = [fid for fid, want in expected.items()
           if (lambda d: d is None or hashlib.sha1(d).hexdigest() != want)(read_fid(fid))]
    assert not bad, "wrong bytes after recovery: %r" % (bad,)


if op == "storm":
    expected = {}
    for i, coll in enumerate(["", "c1", "c2"]):
        r = http_json("POST", "http://%s/vol/grow?collection=%s&count=1" % (master.url, coll))
        assert r == {"count": 1}, r
        a = http_json("GET", "http://%s/dir/assign?collection=%s" % (master.url, coll))
        body = ("%s:%d|" % (coll or "default", i)).encode() * 4096
        s, _ = http_bytes("POST", "http://%s/%s" % (a["url"], a["fid"]), body)
        assert s == 201, (s, a)
        expected[a["fid"]] = hashlib.sha1(body).hexdigest()
    json.dump(expected, open(expected_file, "w"))
    time.sleep(1.5)  # the heat decays into the cool band (half-life 0.25 s)
    if faultspec:
        faultpoints._parse_env(faultspec)
    executed = run_ticks()
    done = [(k, v) for k, v, st in executed if st == "done"]
    assert len(done) == len(set(done)), "duplicate moves: %r" % (executed,)
    check_converged()
    print("STORM " + json.dumps(executed))
elif op == "verify":
    time.sleep(1.5)  # both servers beat their volumes and shards in
    lc._recover()
    st = lc.status()
    print("RECOVERY " + json.dumps(st["recovery"]))
    print("COUNTERS " + json.dumps(st["counters"]))
    executed = run_ticks()
    done = [(k, v) for k, v, st in executed if st == "done"]
    assert len(done) == len(set(done)), "duplicate moves: %r" % (executed,)
    check_converged()
    print("VERIFY " + json.dumps(executed))
else:
    raise SystemExit("unknown op " + op)

for v in vservers:
    v.stop()
master.stop()
print("CHILD-COMPLETED")
"""


def run_child(statedir, op, faultspec=None, expect_crash=False, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, SWEED_HEAT_HALFLIFE="0.25",
               SWEED_LIFECYCLE_COLD_STREAK="1", SWEED_LIFECYCLE_MAX_ACTIONS="6",
               SWEED_LIFECYCLE_BUDGETS="ec=6")
    for var in LIFECYCLE_ENV[:4]:
        env.pop(var, None)
    argv = [sys.executable, "-c", CHILD, str(statedir), op] + ([faultspec] if faultspec else [])
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if expect_crash:
        assert proc.returncode == faultpoints.CRASH_EXIT_CODE, (
            proc.returncode, proc.stdout[-800:], proc.stderr[-2000:])
        assert "CHILD-COMPLETED" not in proc.stdout
    else:
        assert proc.returncode == 0, (proc.returncode, proc.stdout[-1000:], proc.stderr[-3000:])
        assert "CHILD-COMPLETED" in proc.stdout
    return proc


def child_json(proc, tag):
    for ln in proc.stdout.splitlines():
        if ln.startswith(tag + " "):
            return json.loads(ln[len(tag) + 1:])
    raise AssertionError(f"no {tag} line in: {proc.stdout[-500:]}")


def _statedir(tmp_path):
    (tmp_path / "meta").mkdir()
    return tmp_path


def _generated_once(statedir):
    with open(os.path.join(statedir, "generates")) as f:
        counts = collections.Counter(int(v) for v in f.read().split())
    with open(os.path.join(statedir, "expected.json")) as f:
        seeded = {int(fid.split(",")[0]) for fid in json.load(f)}
    assert set(counts) == seeded and set(counts.values()) == {1}, counts


def test_autopilot_converges_without_faults(tmp_path):
    statedir = _statedir(tmp_path)
    done = child_json(run_child(statedir, "storm"), "STORM")
    assert sorted(k for k, _, st in done if st == "done") == ["ec"] * 3, done
    _generated_once(statedir)


# (the storm's fault, least resumed, abandoned): each journal window leaves
# a durable state the recovery must classify
FAST_MATRIX = [
    ("lifecycle.journal.planned=crash", 0, 1),  # planned, nothing started
    ("lifecycle.journal.running=crash", 1, None),  # the first action marked running
]


@pytest.mark.parametrize("faultspec,min_resumed,abandoned", FAST_MATRIX,
                         ids=[m[0].split("=")[0] for m in FAST_MATRIX])
def test_kill_master_matrix_fast(tmp_path, faultspec, min_resumed, abandoned):
    statedir = _statedir(tmp_path)
    run_child(statedir, "storm", faultspec, expect_crash=True)
    proc = run_child(statedir, "verify")
    counters = child_json(proc, "COUNTERS")
    assert counters["resumed"] >= min_resumed, counters
    if abandoned is not None:
        assert counters["abandoned"] >= abandoned, counters
    assert child_json(proc, "RECOVERY"), proc.stdout[-500:]
    # every seeded volume generated once over the crashed run and its replay
    _generated_once(statedir)
