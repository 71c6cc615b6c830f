"""Master daemon: HTTP surface over the cluster core.

Endpoint map (reference handler → here), the same wire surface as the JAX
package's master, so its shell and volume servers talk to this one:

    /dir/assign        master_server_handlers.go:96  → GET/POST /dir/assign
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
    /dir/status, /cluster/status                     → GET (topology json)
    fleet EC scheduler (cluster/fleet.py)            → /ec/fleet/{encode,
                                                       rebuild,status}
    master_ui, metrics                               → GET /ui, /metrics

Differences from the JAX package's master:

- One master, always its own leader: the heartbeat ack names this master's
  url as ``leader``, ``/dir/status`` reports ``is_leader`` true and a
  constant ``term``. Election (``/cluster/vote``, ``/cluster/leader_beat``
  and the proxying to a leader), fid leases (``/dir/fid_lease``) and the
  lifecycle autopilot (``/lifecycle/*``) are not ported yet, nor are
  ``-peers`` and ``-mdir``.
- No ``/debug/traces`` yet (tracing is not ported), and ``/dir/status``
  drops the sections of the subsystems the port lacks (``locks``,
  ``serving``, ``fid_leases``, ``trace``, ``lifecycle``).
- The assign-latency histogram is this master's own (the JAX package's is
  process-wide); ``/metrics`` exposes it beside the process registry under
  the same name, ``master_assign_seconds``.

Nothing starts at import: ``start()`` binds the port and starts the
liveness reaper, ``stop()`` ends both at once.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ..cluster.fleet import EcJobScheduler
from ..cluster.master import Master
from ..cluster.topology import DataNode
from ..cluster.volume_growth import VolumeGrowOption
from ..security import gen_jwt
from ..stats.histogram import Histogram
from ..stats.metrics import default_registry
from ..storage.replica_placement import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, read_ttl
from ..util import glog
from ..util.parsers import tolerant_ufloat, tolerant_uint
from .http_util import JsonHandler, http_json, start_server
from .status_ui import render_status_page

#: the election term a single master reports (it never holds an election)
TERM = 1


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
    ):
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
        self._lock = threading.Lock()
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
        # volume servers follow the leader the ack names; a single master
        # names itself
        ack["leader"] = self.url
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
            "leader": self.url,
            "is_leader": True,
            "term": TERM,
            "topology": self.master.topology_info(),
            # fleet EC scheduler: members + job ledger
            "fleet": self.fleet.stats(),
            # assign latency quantiles from the cumulative-bucket histogram
            "assign": self.assign_hist.summary(op="assign"),
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
                    "leader": self.url,
                    "is_leader": True,
                    "term": TERM,
                    "peers": "",
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

        class Handler(JsonHandler):
            # prefix routes: /dir/lookup_ec before /dir/lookup
            routes = [
                ("GET", "/dir/assign", ms._h_assign),
                ("POST", "/dir/assign", ms._h_assign),
                ("GET", "/dir/lookup_ec", ms._h_lookup_ec),
                ("GET", "/dir/lookup", ms._h_lookup),
                ("GET", "/dir/status", ms._h_status),
                ("POST", "/vol/grow", ms._h_grow),
                ("GET", "/vol/grow", ms._h_grow),
                ("POST", "/vol/vacuum", ms._h_vacuum),
                ("GET", "/vol/vacuum", ms._h_vacuum),
                ("GET", "/col/list", ms._h_collections),
                ("POST", "/col/delete", ms._h_col_delete),
                ("POST", "/cluster/heartbeat", ms._h_heartbeat),
                ("POST", "/cluster/lock", ms._h_lock),
                ("POST", "/cluster/unlock", ms._h_unlock),
                ("POST", "/cluster/leave", ms._h_leave),
                ("GET", "/cluster/status", ms._h_status),
                ("GET", "/cluster/ping", ms._h_ping),
                ("GET", "/cluster/watch", ms._h_watch),
                ("POST", "/ec/fleet/encode", ms._h_fleet_encode),
                ("POST", "/ec/fleet/rebuild", ms._h_fleet_rebuild),
                ("GET", "/ec/fleet/status", ms._h_fleet_status),
                ("GET", "/ui", ms._h_ui),
                ("GET", "/metrics", ms._h_metrics),
            ]

        self._srv = start_server(Handler, self.host, self.port)
        # port 0 asks the OS for one; the url reports the bound port
        self.port = self._srv.server_address[1]
        glog.info("master up on %s", self.url)
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name=f"master-reaper-{self.port}")
        self._reaper.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.fleet.stop()
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
        if self._reaper:
            self._reaper.join()
        glog.info("master %s stopped", self.url)
