"""Master daemon: HTTP surface over the cluster core.

Endpoint map (reference handler → here), the same wire surface as the JAX
package's master, so its shell and volume servers talk to this one:

    /dir/assign        master_server_handlers.go:96  → GET/POST /dir/assign
    fid-range leases   (cluster/fid_lease.py)        → GET/POST /dir/fid_lease
    /dir/lookup        master_server_handlers.go:32  → GET /dir/lookup
    LookupEcVolume rpc master_grpc_server_volume.go  → GET /dir/lookup_ec
    SendHeartbeat rpc  master_grpc_server.go:20      → POST /cluster/heartbeat
    /vol/grow          master_server_handlers_admin  → GET/POST /vol/grow
    /vol/vacuum        master_server_handlers_admin  → GET/POST /vol/vacuum
    collection handlers                              → GET /col/list,
                                                       POST /col/delete
    LeaseAdminToken    master_grpc_server_admin.go   → POST /cluster/lock,
                                                       /cluster/unlock
    KeepConnected      master_grpc_server.go:178     → GET /cluster/watch
    VolumeServerLeave                                → POST /cluster/leave
    raft (raft_server.go, cluster/election.py)       → POST /cluster/vote,
                                                       /cluster/leader_beat
    /dir/status, /cluster/status                     → GET (topology json)
    fleet EC scheduler (cluster/fleet.py)            → /ec/fleet/{encode,
                                                       rebuild,status}
    lifecycle autopilot (cluster/lifecycle.py)       → GET /lifecycle/status,
                                                       POST /lifecycle/{pause,
                                                       resume}
    master_ui, metrics                               → GET /ui, /metrics

HA (``peers``): the masters elect a leader among themselves
(``cluster/election.py``: pre-vote, terms, one vote per term, leading only
while a majority answers). Writes, admin calls and the topology reads go to
the leader; a follower proxies them one hop (``proxyToLeader``). The
leader's beats carry the sequence and volume-id high-water marks, so a new
leader issues neither twice. With ``meta_dir`` the master keeps there, in
the JAX package's formats, its vote (``election_{port}.json``), its fid-lease
journal (``fid_leases_{port}.jsonl``, replayed into the sequencer at start)
and the autopilot's plan journal (``lifecycle_{port}.json``). The autopilot
runs on the leader only, and only with ``SWEED_LIFECYCLE=1``.

``/debug/traces`` serves the process's span ring (``stats/trace.py``).
Differences from the JAX package's master: ``/dir/status`` drops the
sections of the subsystems the port lacks (``locks``, ``serving``). The
assign-latency histogram is this master's own (the JAX package's is
process-wide); ``/metrics`` exposes it beside the process registry under the
same name, ``master_assign_seconds``.

Nothing starts at import: ``start()`` binds the port and starts the
liveness reaper, the election and the autopilot; ``stop()`` ends them.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from typing import Optional

from ..cluster.election import LeaderElection
from ..cluster.fid_lease import FidLeaseManager
from ..cluster.fleet import EcJobScheduler
from ..cluster.lifecycle import (
    ClusterOps,
    LifecycleConfig,
    LifecycleController,
    observe_topology,
)
from ..cluster.master import Master
from ..cluster.topology import DataNode
from ..cluster.volume_growth import VolumeGrowOption
from ..security import gen_jwt
from ..stats import trace
from ..stats.histogram import Histogram
from ..stats.metrics import default_registry
from ..storage.file_id import FileId
from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, read_ttl
from ..util import glog
from ..util.locks import lock_stats, make_lock
from ..util.parsers import tolerant_ufloat, tolerant_uint
from .http_util import SERVING, JsonHandler, http_json, start_server
from .status_ui import render_status_page

# Beats checkpoint the sequence ahead of use (peek + margin), as the
# reference's batch-allocating sequencer rides raft snapshots: ids handed out
# between two beats never collide after a failover, since the new leader
# starts past the margin (gaps in needle ids are harmless).
SEQ_MARGIN = 1_000_000
# the volume-id margin covers the grows in the <= lease/3 between two beats
VID_MARGIN = 64


class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 9333,
        volume_size_limit_mb: int = 30 * 1024,
        default_replication: str = "000",
        garbage_threshold: float = 0.3,
        node_timeout: float = 15.0,
        jwt_signing_key: str = "",
        jwt_expires_seconds: int = 10,
        peers: Optional[list[str]] = None,
        lease_seconds: float = 3.0,
        meta_dir: Optional[str] = None,
    ):
        if port == 0 and (peers or meta_dir):
            raise ValueError("peers and meta_dir name a master by its port: give one")
        self.jwt_signing_key = jwt_signing_key
        self.jwt_expires_seconds = jwt_expires_seconds
        self.host, self.port = host, port
        self.master = Master(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            default_replication=default_replication,
            allocate_volume=self._allocate_volume,
            garbage_threshold=garbage_threshold,
        )
        self.node_timeout = node_timeout
        self._nodes: dict[str, DataNode] = {}
        self._lock = make_lock("MasterServer._lock")
        # fleet EC scheduler: fans encode/rebuild jobs over the volume
        # servers (cluster/fleet.py); membership rides heartbeats
        self.fleet = EcJobScheduler(
            locate=lambda vid: self.master.lookup_volume(vid, "")
        )
        self._srv = None
        self._reaper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # fid allocation latency through /dir/assign: /dir/status p50/p99
        self.assign_hist = Histogram(
            "master_assign_seconds",
            "fid allocation latency through /dir/assign",
        )
        if meta_dir:
            os.makedirs(meta_dir, exist_ok=True)

        def meta(name: str) -> Optional[str]:
            return os.path.join(meta_dir, name) if meta_dir else None

        # HA (raft_server.go): a single master is its own leader at once
        self.election = LeaderElection(
            self.url,
            peers or [self.url],
            lease_seconds=lease_seconds,
            get_max_file_key=lambda: self.master.sequencer.peek() + SEQ_MARGIN,
            on_checkpoint=self.master.sequencer.set_max,
            get_max_volume_id=lambda: self.master.topo.max_volume_id + VID_MARGIN,
            on_volume_id_checkpoint=self.master.topo.checkpoint_max_volume_id,
            state_path=meta(f"election_{port}.json"),
        )
        # fid-range leases: the grant journal replays into the sequencer
        # before it issues anything, so a restarted master never issues a
        # leased key again (the beats' margin covers a failover between
        # masters; the journal covers a restart of this one)
        self.fid_leases = FidLeaseManager(meta(f"fid_leases_{port}.jsonl"))
        self.fid_leases.replay(self.master.sequencer.set_max)
        # the autopilot: always built (so /lifecycle/status answers and the
        # journal's recovery shows), its loop runs with SWEED_LIFECYCLE=1
        self.lifecycle_enabled = os.environ.get("SWEED_LIFECYCLE") == "1"
        lcfg = LifecycleConfig.from_env()
        self.lifecycle = LifecycleController(
            journal_path=meta(f"lifecycle_{port}.json"),
            config=lcfg,
            observe=lambda: observe_topology(self),
            ops=ClusterOps(self.url, lcfg),
            is_leader=lambda: self.election.is_leader,
            lease=lambda client: self.master.lease_admin_token(client),
            release=self.master.release_admin_token,
        )

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    # -- volume allocation via the volume server's admin endpoint -----------
    def _allocate_volume(self, dn: DataNode, vid: int, option) -> None:
        r = http_json(
            "POST",
            f"http://{dn.url()}/admin/assign_volume?volume={vid}"
            f"&collection={option.collection}&replication={option.replica_placement}"
            f"&ttl={option.ttl}",
        )
        if r.get("error"):
            raise RuntimeError(f"allocate volume {vid} on {dn.url()}: {r['error']}")

    # -- leader proxying (master_server.go proxyToLeader) --------------------
    def _proxy_to_leader(self, h, path, q, body):
        leader = self.election.leader
        if leader is None:
            return 503, {"error": "no leader elected yet"}
        # one hop at most, as the reference's proxyToLeader: while leadership
        # flaps two masters may each name the other, and a request would
        # bounce between them until the threads run out
        q = dict(q, proxied="1")
        url = f"http://{leader}{path}?{urllib.parse.urlencode(q)}"
        try:
            # the fleet's encode waits for its jobs (wait=1): the shell's own
            # timeout, not the default 30 s
            r = http_json(h.command, url, body=body or None, timeout=600)
        except Exception as e:  # noqa: BLE001 — the client gets a 502 naming it
            return 502, {"error": f"proxy to leader {leader}: {e}"}
        return r.pop("_status", 200), r

    def _leader_only(self, handler):
        def wrapped(h, path, q, body):
            if not self.election.is_leader:
                if q.get("proxied"):
                    return 503, {"error": "leadership unsettled (proxy loop)"}
                return self._proxy_to_leader(h, path, q, body)
            return handler(h, path, q, body)

        return wrapped

    # -- handlers ------------------------------------------------------------
    def _h_assign(self, h, path, q, body):
        with self.assign_hist.time(op="assign"):
            res = self.master.assign(
                count=tolerant_uint(q.get("count", 1), 1),
                replication=q.get("replication", ""),
                collection=q.get("collection", ""),
                ttl=q.get("ttl", ""),
                data_center=q.get("dataCenter", ""),
            )
        out = {
            "fid": res.fid,
            "url": res.url,
            "publicUrl": res.public_url,
            "count": res.count,
            "replicas": res.replicas,
        }
        if self.jwt_signing_key:
            # fid-scoped write token (security/jwt.go GenJwt via dirAssign)
            out["auth"] = gen_jwt(
                self.jwt_signing_key, res.fid, self.jwt_expires_seconds
            )
        return 200, out

    def _h_fid_lease(self, h, path, q, body):
        """``/dir/fid_lease?client=<name>&count=N``: grant a needle-key range
        that the client mints fids from itself; ``?renew=<lease_id>``
        extends a live lease. The range is reserved through the assign path
        and journaled durably before this reply leaves."""
        renew_id = q.get("renew", "")
        if renew_id:
            exp = self.fid_leases.renew(renew_id)
            if exp is None:
                return 404, {"error": f"unknown or expired lease {renew_id}"}
            return 200, {"lease_id": renew_id, "expires": exp}
        count = max(1, min(tolerant_uint(q.get("count", 128), 128), 1 << 16))
        with self.assign_hist.time(op="lease"):
            res = self.master.assign(
                count=count,
                replication=q.get("replication", ""),
                collection=q.get("collection", ""),
                ttl=q.get("ttl", ""),
                data_center=q.get("dataCenter", ""),
            )
        base = FileId.parse(res.fid)
        reg = self.fid_leases.register(q.get("client", h.client_address[0]),
                                       base.volume_id, base.key, count)
        out = {
            "fid": res.fid,
            "url": res.url,
            "publicUrl": res.public_url,
            "count": count,
            "lease_id": reg["lease_id"],
            "expires": reg["expires"],
        }
        if self.jwt_signing_key:
            # the token covers the base fid only; the client signs the fids
            # it mints with its own key (or refuses the lease without one)
            out["auth"] = gen_jwt(self.jwt_signing_key, res.fid, self.jwt_expires_seconds)
        return 200, out

    def _h_lookup(self, h, path, q, body):
        vid_str = q.get("volumeId", "")
        if "," in vid_str:
            vid_str = vid_str.split(",")[0]
        locations = self.master.lookup_volume(int(vid_str), q.get("collection", ""))
        if not locations:
            return 404, {"volumeId": vid_str, "error": "volume id not found"}
        return 200, {"volumeId": vid_str, "locations": locations}

    def _h_lookup_ec(self, h, path, q, body):
        vid = tolerant_uint(q.get("volumeId", "0"), 0)
        res = self.master.lookup_ec_volume(vid)
        if not res["shard_id_locations"]:
            return 404, {"error": f"ec volume {vid} not found"}
        return 200, res

    def _h_heartbeat(self, h, path, q, body):
        hb = json.loads(body)
        url = f"{hb['ip']}:{hb['port']}"
        # registration AND heartbeat application under one lock so the
        # reaper can't disconnect the node between the two (an orphaned
        # DataNode re-registered here would leak stale locations forever)
        with self._lock:
            dn = self._nodes.get(url)
            if dn is None:
                dn = self.master.register_data_node(
                    hb["ip"],
                    hb["port"],
                    public_url=hb.get("public_url", ""),
                    data_center=hb.get("data_center", "DefaultDataCenter"),
                    rack=hb.get("rack", "DefaultRack"),
                    max_volume_count=hb.get("max_volume_count", 7),
                )
                self._nodes[url] = dn
            ack = self.master.handle_heartbeat(dn, hb)
        # mesh coordinates ride the beat: the fleet scheduler's membership
        # is exactly heartbeat freshness
        if "mesh" in hb:
            self.fleet.observe_member(url, hb.get("mesh"))
        # announce the leader, so volume servers follow a failover
        # (volume_grpc_client_to_master.go:155-197)
        ack["leader"] = self.election.leader
        return 200, ack

    def _h_grow(self, h, path, q, body):
        rp = ReplicaPlacement.from_string(
            q.get("replication", str(self.master.default_replication))
        )
        option = VolumeGrowOption(
            collection=q.get("collection", ""),
            replica_placement=rp,
            ttl=read_ttl(q["ttl"]) if q.get("ttl") else EMPTY_TTL,
            data_center=q.get("dataCenter", ""),
        )
        count = tolerant_uint(q.get("count", 1), 1)
        grown = self.master.vg.grow_by_count(self.master.topo, option, count)
        return 200, {"count": grown}

    def _h_vacuum(self, h, path, q, body):
        threshold = tolerant_ufloat(
            q.get("garbageThreshold", ""), self.master.garbage_threshold
        )

        def check(dn, vid):
            r = http_json("GET", f"http://{dn.url()}/admin/vacuum_check?volume={vid}")
            return float(r.get("garbage_ratio", 0.0))

        def compact(dn, vid):
            r = http_json("POST", f"http://{dn.url()}/admin/vacuum?volume={vid}")
            return not r.get("error")

        compacted = self.master.vacuum(check, compact, threshold)
        return 200, {"compacted": compacted}

    def _h_col_delete(self, h, path, q, body):
        name = q.get("collection", "")
        vids = self.master.collection_delete(name)
        # propagate deletion to the volume servers holding those volumes
        for url, dn in list(self._nodes.items()):
            for vid in vids:
                if vid in dn.volumes:
                    http_json("POST", f"http://{url}/admin/delete_volume?volume={vid}")
        return 200, {"collection": name, "volumes": vids}

    def _h_collections(self, h, path, q, body):
        return 200, {"collections": self.master.collection_list()}

    def _h_status(self, h, path, q, body):
        return 200, {
            "version": "seaweedfs_tpu_torch 0.1",
            "leader": self.election.leader,
            "is_leader": self.election.is_leader,
            "term": self.election.term,
            "topology": self.master.topology_info(),
            # OrderedLock sanitizer counters + observed order edges
            # (all-zero unless the process runs with SWEED_LOCK_CHECK=1)
            "locks": lock_stats(),
            # serving-core counters (mode, inflight, admission shedding)
            "serving": SERVING.snapshot(),
            # fleet EC scheduler: members + job ledger
            "fleet": self.fleet.stats(),
            # assign latency quantiles from the cumulative-bucket histogram
            "assign": self.assign_hist.summary(op="assign"),
            # fid-range leases: live, granted, replayed
            "fid_leases": self.fid_leases.stats(),
            "trace": trace.trace_stats(),
            # the autopilot: cycle counters, interlock, recovery
            "lifecycle": {"enabled": self.lifecycle_enabled, **self.lifecycle.status()},
        }

    def _h_ping(self, h, path, q, body):
        return 200, {"ok": True, "url": self.url}

    def _h_ui(self, h, path, q, body):
        """The embedded status page (server/master_ui analog)."""
        h.extra_headers = {"Content-Type": "text/html; charset=utf-8"}
        return 200, render_status_page(
            f"seaweedfs_tpu_torch master {self.url}",
            {
                "Cluster": {
                    "leader": self.election.leader,
                    "is_leader": self.election.is_leader,
                    "term": self.election.term,
                    "peers": ", ".join(self.election.peers),
                    "volume_size_limit": self.master.topo.volume_size_limit,
                    "max_volume_id": self.master.topo.max_volume_id,
                },
                "Topology": self.master.topology_info(),
            },
        )

    def _h_metrics(self, h, path, q, body):
        h.extra_headers = {"Content-Type": "text/plain; version=0.0.4"}
        text = default_registry.expose() + "\n".join(self.assign_hist.expose()) + "\n"
        return 200, text.encode()

    # -- election (raft_server.go) ------------------------------------------
    def _h_leader_beat(self, h, path, q, body):
        b = json.loads(body)
        return 200, self.election.receive_beat(
            b["leader"], b["term"], b.get("max_file_key", 0), b.get("max_volume_id", 0))

    def _h_vote(self, h, path, q, body):
        b = json.loads(body)
        return 200, self.election.receive_vote_request(
            b["candidate"], b["term"], b.get("max_file_key", 0), b.get("max_volume_id", 0),
            b.get("prevote", False))

    # -- lifecycle autopilot (cluster/lifecycle.py) --------------------------
    def _h_lifecycle_status(self, h, path, q, body):
        return 200, {**self.lifecycle.status(), "enabled": self.lifecycle_enabled}

    def _h_lifecycle_pause(self, h, path, q, body):
        self.lifecycle.pause()
        return 200, {"paused": True}

    def _h_lifecycle_resume(self, h, path, q, body):
        self.lifecycle.resume()
        return 200, {"paused": False}

    def _h_lock(self, h, path, q, body):
        try:
            token = self.master.lease_admin_token(
                q.get("client", "shell"), q.get("previous") or None
            )
            return 200, {"token": token}
        except RuntimeError as e:
            return 409, {"error": str(e)}

    def _h_unlock(self, h, path, q, body):
        self.master.release_admin_token(q.get("token", ""))
        return 200, {}

    def _h_watch(self, h, path, q, body):
        # KeepConnected analog (master_grpc_server.go:178): long-poll for
        # VolumeLocation deltas past `since`; a snapshot when the client is
        # too far behind the retained log
        since = tolerant_uint(q.get("since", 0), 0)
        timeout = min(tolerant_ufloat(q.get("timeout", 10.0), 10.0), 30.0)
        return 200, self.master.location_deltas(since, timeout)

    # -- fleet EC scheduling (cluster/fleet.py) ------------------------------
    def _h_fleet_encode(self, h, path, q, body):
        """POST /ec/fleet/encode?volumeIds=1,2,3[&collection=c][&wait=1]: fan
        /admin/ec/generate over the volume holders. With wait=1 the reply
        carries the settled job states; the shell's -fleet path spreads the
        shards from them."""
        raw = q.get("volumeIds", q.get("volumeId", ""))
        vids = [tolerant_uint(v, None) for v in raw.split(",") if v.strip()]
        if not vids or None in vids:
            return 400, {"error": f"bad volumeIds={raw!r}"}
        collection = q.get("collection", "")
        jids = [self.fleet.submit("encode", vid, collection) for vid in vids]
        settled = True
        if q.get("wait") == "1":
            settled = self.fleet.wait(
                jids, timeout=tolerant_ufloat(q.get("timeout", ""), 600.0)
            )
        return 200, {
            "jobs": [self.fleet.job_info(j) for j in jids],
            "settled": settled,
        }

    def _h_fleet_rebuild(self, h, path, q, body):
        vid = tolerant_uint(q.get("volumeId", ""), None)
        if vid is None:
            return 400, {"error": f"bad volumeId={q.get('volumeId')!r}"}
        jid = self.fleet.submit("rebuild", vid, q.get("collection", ""))
        if q.get("wait") == "1":
            self.fleet.wait(
                [jid], timeout=tolerant_ufloat(q.get("timeout", ""), 600.0)
            )
        return 200, {"jobs": [self.fleet.job_info(jid)]}

    def _h_fleet_status(self, h, path, q, body):
        return 200, self.fleet.stats()

    # -- liveness (master_grpc_server.go:22-50 on stream close) --------------
    def _drop_node(self, url: str, dn: DataNode) -> None:
        self.master.handle_node_disconnect(dn)
        self.fleet.drop_member(url)

    def _h_leave(self, h, path, q, body):
        """A volume server announces a graceful leave: deregister now
        instead of waiting out the liveness timeout."""
        url = q.get("url", "")
        with self._lock:
            dn = self._nodes.pop(url, None)
        if dn is None:
            return 404, {"error": f"unknown node {url}"}
        self._drop_node(url, dn)
        return 200, {"left": url}

    def _reap_loop(self) -> None:
        while not self._stop.wait(self.node_timeout / 3):
            now = time.time()
            # expired leases leave the live table (their ranges stay burned
            # in the journal)
            self.fid_leases.expire_stale()
            with self._lock:
                for url, dn in list(self._nodes.items()):
                    # scale to the node's own reported pulse so a long
                    # -pulseSeconds doesn't get a healthy node reaped
                    timeout = max(self.node_timeout, 2.5 * dn.pulse_seconds)
                    if now - dn.last_seen > timeout:
                        glog.warning("master: %s missed its heartbeats; dropped", url)
                        del self._nodes[url]
                        self._drop_node(url, dn)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MasterServer":
        ms = self

        lead = ms._leader_only

        class Handler(JsonHandler):
            trace_service = "master"
            # prefix routes: /dir/lookup_ec before /dir/lookup
            routes = [
                ("GET", "/debug/traces", trace.h_debug_traces),
                # leader-only (writes, admin): a follower proxies to the leader
                ("GET", "/dir/assign", lead(ms._h_assign)),
                ("POST", "/dir/assign", lead(ms._h_assign)),
                ("POST", "/vol/grow", lead(ms._h_grow)),
                ("GET", "/vol/grow", lead(ms._h_grow)),
                ("POST", "/vol/vacuum", lead(ms._h_vacuum)),
                ("GET", "/vol/vacuum", lead(ms._h_vacuum)),
                ("POST", "/col/delete", lead(ms._h_col_delete)),
                ("POST", "/dir/fid_lease", lead(ms._h_fid_lease)),
                ("GET", "/dir/fid_lease", lead(ms._h_fid_lease)),
                ("POST", "/cluster/lock", lead(ms._h_lock)),
                ("POST", "/cluster/unlock", lead(ms._h_unlock)),
                # only the leader's topology knows the fleet's members
                ("POST", "/ec/fleet/encode", lead(ms._h_fleet_encode)),
                ("POST", "/ec/fleet/rebuild", lead(ms._h_fleet_rebuild)),
                ("GET", "/ec/fleet/status", lead(ms._h_fleet_status)),
                # only the leader runs the autopilot
                ("GET", "/lifecycle/status", lead(ms._h_lifecycle_status)),
                ("POST", "/lifecycle/pause", lead(ms._h_lifecycle_pause)),
                ("POST", "/lifecycle/resume", lead(ms._h_lifecycle_resume)),
                # reads proxy too: heartbeats feed the leader's topology (the
                # reference wraps these in proxyToLeader as well)
                ("GET", "/dir/lookup_ec", lead(ms._h_lookup_ec)),
                ("GET", "/dir/lookup", lead(ms._h_lookup)),
                ("GET", "/col/list", lead(ms._h_collections)),
                ("GET", "/cluster/watch", lead(ms._h_watch)),
                ("GET", "/dir/status", ms._h_status),
                ("POST", "/cluster/heartbeat", ms._h_heartbeat),
                ("POST", "/cluster/leave", ms._h_leave),
                ("GET", "/cluster/status", ms._h_status),
                ("GET", "/cluster/ping", ms._h_ping),
                ("POST", "/cluster/leader_beat", ms._h_leader_beat),
                ("POST", "/cluster/vote", ms._h_vote),
                ("GET", "/ui", ms._h_ui),
                ("GET", "/metrics", ms._h_metrics),
            ]

        self._srv = start_server(Handler, self.host, self.port)
        if self.port == 0:
            # the OS picked the port: this lone master is named by it
            self.port = self._srv.server_address[1]
            self.election.self_url = self.url
            self.election.peers = [self.url]
            self.lifecycle.ops.master_url = self.url
        glog.info("master up on %s (peers: %s)", self.url, ",".join(self.election.peers))
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name=f"master-reaper-{self.port}")
        self._reaper.start()
        self.election.start()
        if self.lifecycle_enabled:
            self.lifecycle.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.election.stop()
        self.lifecycle.stop()
        self.fleet.stop()
        self.fid_leases.close()
        if self._srv:
            self._srv.shutdown()
            self.master.release_watchers()  # no new request comes in now
            self._srv.server_close()
        if self._reaper:
            self._reaper.join()
        glog.info("master %s stopped", self.url)
