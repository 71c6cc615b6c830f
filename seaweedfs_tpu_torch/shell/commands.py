"""Admin shell commands over the master, volume server and filer HTTP
surfaces, ported from the JAX package's shell (`weed/shell/`):
    volume.list, volume.delete, volume.mark (readonly|writable)
    volume.vacuum (the master's /vol/vacuum), volume.copy, volume.move,
    volume.mount / volume.unmount, volume.configure.replication,
    volume.fix.replication, volume.balance (by count or by heat),
    volumeServer.evacuate (volumes and EC shards), volumeServer.leave
    ec.encode   (command_ec_encode.go:55 — readonly → generate → spread;
                 -fleet hands the generate step to the master's scheduler)
    ec.rebuild  (command_ec_rebuild.go:57 — copy ≥k shards → rebuild → mount)
    ec.decode   (command_ec_decode.go — collect shards → to_volume)
    ec.balance  (command_ec_balance.go — even shard spread across servers)
    volume.tier.upload / volume.tier.download (the S3-class cold tier)
    lifecycle.status / lifecycle.pause / lifecycle.resume (the autopilot)
    collection.list / collection.delete, cluster.status, lock / unlock
    volume.fsck (command_volume_fsck.go — orphan needles against the filer)
    fs.cd/pwd/ls/du/tree/cat/mv, fs.meta.cat/save/load/notify,
    fs.configure (command_fs_*.go, over the filer)
    bucket.list/create/delete (command_bucket_*.go)
    query (the filer's /_query), trace (the daemons' span rings),
    remote.dlq (the replication dead-letter queues)

Every command is a plain function usable programmatically; ``shell.py``
wraps them in the REPL. Each EC step runs on the volume servers' admin
endpoints, where the GF(2^8) product goes through the store's codec; a
``query`` runs the scan on the filer's (or the needle's volume server's)
device.
"""

from __future__ import annotations

import json
import os
import time
import urllib.parse
from dataclasses import dataclass
from typing import Optional

from ..ec.constants import TOTAL_SHARDS
from ..filer.filer_conf import FILER_CONF_PATH, FilerConf
from ..server.http_util import http_bytes, http_json
from ..stats.trace import assemble_tree, format_tree
from ..storage.file_id import format_needle_id_cookie, parse_path
from ..storage.replica_placement import ReplicaPlacement
from ..util import glog
from ..util.config import load_configuration
from ..wdclient import find_reachable_master


@dataclass
class CommandEnv:
    master: str
    token: Optional[str] = None
    filer: str = ""  # the filer of fs.*, bucket.*, volume.fsck, query and trace
    cwd: str = "/"  # the fs.* working directory (command_fs_cd.go)

    def __post_init__(self):
        # -master accepts a comma list (shell.go ShellOptions.Masters); pin
        # to a verified-reachable seed
        self.master_seeds = [
            m.strip() for m in self.master.split(",") if m.strip()
        ]
        if self.master_seeds:
            self.master = (
                self.master_seeds[0]
                if len(self.master_seeds) == 1
                else find_reachable_master(self.master_seeds)
            )

    def re_resolve_master(self) -> bool:
        """Mid-session failover: pick a (different) verified-reachable seed
        after a connection failure. True only when the pinned master changed
        to a seed that answered the probe — if nothing answers, the pin is
        left alone (never trade a known address for an unverified one)."""
        if len(self.master_seeds) <= 1:
            return False
        others = [m for m in self.master_seeds if m != self.master]
        new = find_reachable_master(others + [self.master], strict=True)
        if not new or new == self.master:
            return False
        self.master = new
        return True

    def lock(self) -> str:
        r = http_json("POST", f"http://{self.master}/cluster/lock?client=shell")
        if r.get("error"):
            raise RuntimeError(r["error"])
        self.token = r["token"]
        return self.token

    def unlock(self) -> None:
        if self.token:
            http_json(
                "POST", f"http://{self.master}/cluster/unlock?token={self.token}"
            )
            self.token = None

    # -- cluster introspection ----------------------------------------------
    def topology(self) -> dict:
        return http_json("GET", f"http://{self.master}/dir/status")["topology"]

    def data_nodes(self) -> list[dict]:
        return [
            n
            for dc in self.topology()["data_centers"]
            for r in dc["racks"]
            for n in r["nodes"]
        ]

    def node_status(self, url: str) -> dict:
        return http_json("GET", f"http://{url}/status")

    def volume_locations(self, vid: int) -> list[str]:
        r = http_json("GET", f"http://{self.master}/dir/lookup?volumeId={vid}")
        return [l["url"] for l in r.get("locations", [])]

    def ec_shard_locations(self, vid: int) -> dict[int, list[str]]:
        r = http_json("GET", f"http://{self.master}/dir/lookup_ec?volumeId={vid}")
        return {
            int(sid): urls
            for sid, urls in r.get("shard_id_locations", {}).items()
        }


# -- informational commands --------------------------------------------------
def volume_list(env: CommandEnv) -> list[dict]:
    out = []
    for n in env.data_nodes():
        st = env.node_status(n["url"])
        for v in st.get("volumes", []):
            out.append({**v, "server": n["url"]})
    return out


def cluster_status(env: CommandEnv) -> dict:
    return env.topology()


# -- the lifecycle autopilot (cluster/lifecycle.py) ----------------------------
def _lifecycle(env: CommandEnv, method: str, verb: str) -> dict:
    """The leader answers; a follower proxies to it."""
    r = http_json(method, f"http://{env.master}/lifecycle/{verb}")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return r


def lifecycle_status(env: CommandEnv) -> dict:
    """lifecycle.status: cycle counters, the interlock, the last plan and
    the journal's recovery."""
    return _lifecycle(env, "GET", "status")


def lifecycle_pause(env: CommandEnv) -> dict:
    """lifecycle.pause: schedule nothing new (a move in flight finishes; it
    is staged-commit protected either way)."""
    return _lifecycle(env, "POST", "pause")


def lifecycle_resume(env: CommandEnv) -> dict:
    return _lifecycle(env, "POST", "resume")


def collection_list(env: CommandEnv) -> list[str]:
    return http_json("GET", f"http://{env.master}/col/list")["collections"]


def collection_delete(env: CommandEnv, name: str) -> dict:
    return http_json("POST", f"http://{env.master}/col/delete?collection={name}")


# -- volume commands ----------------------------------------------------------
def volume_vacuum(env: CommandEnv, garbage_threshold: float = 0.3) -> list[int]:
    """volume.vacuum (command_volume_vacuum.go): the master checks every
    replica's garbage ratio and compacts the volumes above the threshold."""
    r = http_json(
        "POST",
        f"http://{env.master}/vol/vacuum?garbageThreshold={garbage_threshold}",
    )
    return r.get("compacted", [])


def volume_delete(env: CommandEnv, vid: int) -> None:
    for url in env.volume_locations(vid):
        http_json("POST", f"http://{url}/admin/delete_volume?volume={vid}")


def volume_mark_readonly(env: CommandEnv, vid: int) -> None:
    for url in env.volume_locations(vid):
        http_json("POST", f"http://{url}/admin/readonly?volume={vid}")


def volume_mark(env: CommandEnv, vid: int, writable: bool,
                node: str = "") -> None:
    """volume.mark -readonly|-writable (command_volume_mark.go): flip one
    volume's write gate on its server(s), or on one server with -node."""
    op = "writable" if writable else "readonly"
    urls = [node] if node else env.volume_locations(vid)
    for url in urls:
        http_json("POST", f"http://{url}/admin/{op}?volume={vid}")


# -- EC commands (the north-star workload) ------------------------------------
def _volume_collection(env: CommandEnv, vid: int) -> str:
    """Resolve a volume's collection from the servers' status reports."""
    for v in volume_list(env):
        if v["id"] == vid:
            return v.get("collection", "")
    return ""


def ec_encode(
    env: CommandEnv,
    vid: int,
    collection: Optional[str] = None,
    delete_original: bool = True,
) -> dict:
    """command_ec_encode.go:92 doEcEncode: mark readonly → generate 14
    shards on the source server → spread across servers → register → drop
    the plain volume."""
    locations = env.volume_locations(vid)
    if not locations:
        raise RuntimeError(f"volume {vid} not found")
    if collection is None or collection == "":
        collection = _volume_collection(env, vid)
    source = locations[0]
    volume_mark_readonly(env, vid)
    r = http_json("POST", f"http://{source}/admin/ec/generate?volume={vid}")
    if r.get("error"):
        raise RuntimeError(f"generate: {r['error']}")
    return _spread_and_finish(env, vid, collection, source, locations,
                              delete_original)


def _spread_and_finish(
    env: CommandEnv,
    vid: int,
    collection: str,
    source: str,
    locations: list[str],
    delete_original: bool,
) -> dict:
    """Post-generate half of doEcEncode: spread the 14 shards round-robin,
    mount everywhere, drop the plain volume."""
    plan = _spread_plan(env, source)
    for target, shard_ids in plan.items():
        if target == source or not shard_ids:
            continue
        shards = ",".join(str(s) for s in shard_ids)
        r = http_json(
            "POST",
            f"http://{target}/admin/ec/copy?volume={vid}&collection={collection}"
            f"&source={source}&shards={shards}",
        )
        if r.get("error"):
            raise RuntimeError(f"copy to {target}: {r['error']}")
        http_json("POST", f"http://{target}/admin/ec/mount?volume={vid}")
        http_json(
            "POST",
            f"http://{source}/admin/ec/delete_shards?volume={vid}&shards={shards}",
        )
    http_json("POST", f"http://{source}/admin/ec/mount?volume={vid}")

    if delete_original:
        for url in locations:
            http_json("POST", f"http://{url}/admin/delete_volume?volume={vid}")
    return {"volume": vid, "spread": {t: s for t, s in plan.items() if s}}


def ec_encode_fleet(
    env: CommandEnv,
    vids: list[int],
    collection: Optional[str] = None,
    delete_original: bool = True,
) -> dict:
    """ec.encode -fleet: mark every volume readonly, hand the whole batch to
    the MASTER's fleet scheduler (POST /ec/fleet/encode — it fans
    /admin/ec/generate across the mesh-registered holders in parallel, each
    staged-commit protected), then spread/mount/drop per volume exactly as
    the single-volume path does. One shell process no longer serializes the
    fleet's encode throughput."""
    if not vids:
        raise RuntimeError("ec.encode -fleet: no volume ids")
    locations: dict[int, list[str]] = {}
    collections: dict[int, str] = {}
    for vid in vids:
        locs = env.volume_locations(vid)
        if not locs:
            raise RuntimeError(f"volume {vid} not found")
        locations[vid] = locs
        collections[vid] = (
            collection
            if collection
            else _volume_collection(env, vid)
        )
        volume_mark_readonly(env, vid)

    ids = ",".join(str(v) for v in vids)
    r = http_json(
        "POST",
        f"http://{env.master}/ec/fleet/encode?volumeIds={ids}"
        f"&collection={collection or ''}&wait=1",
        timeout=600,
    )
    if r.get("error"):
        raise RuntimeError(f"fleet encode: {r['error']}")
    jobs = {j["volume"]: j for j in r.get("jobs", []) if j}
    failed = [
        f"volume {v}: {j.get('error') or j.get('state')}"
        for v, j in jobs.items()
        if j.get("state") != "done"
    ]
    if failed or len(jobs) < len(vids):
        raise RuntimeError("fleet encode failed: " + "; ".join(
            failed or ["missing job results"]
        ))

    out = {"volumes": [], "jobs": list(jobs.values())}
    for vid in vids:
        # the scheduler encoded on a holder; spread FROM that server
        source = jobs[vid].get("server") or locations[vid][0]
        out["volumes"].append(
            _spread_and_finish(env, vid, collections[vid], source,
                               locations[vid], delete_original)
        )
    return out


def _spread_plan(env: CommandEnv, source: str) -> dict[str, list[int]]:
    """Round-robin balanced distribution (balancedEcDistribution,
    command_ec_encode.go:209): spread 14 shards across all servers, source
    keeps its share."""
    nodes = sorted(n["url"] for n in env.data_nodes())
    if source in nodes:  # source first so it keeps the remainder share
        nodes.remove(source)
        nodes.insert(0, source)
    plan: dict[str, list[int]] = {n: [] for n in nodes}
    for sid in range(TOTAL_SHARDS):
        plan[nodes[sid % len(nodes)]].append(sid)
    return plan


def ec_rebuild(env: CommandEnv, vid: int, collection: str = "") -> dict:
    """command_ec_rebuild.go:57: find missing shards, pick the node with the
    most free room as rebuilder, copy enough sibling shards there, rebuild,
    mount, then drop the copied-in temporaries."""
    by_shard = env.ec_shard_locations(vid)
    present = set(by_shard)
    missing = sorted(set(range(TOTAL_SHARDS)) - present)
    if not missing:
        return {"volume": vid, "rebuilt": []}
    if len(present) < 10:
        raise RuntimeError(
            f"volume {vid}: only {len(present)} shards survive, cannot rebuild"
        )

    # rebuilder = node already holding the most shards (minimizes copying)
    holder_counts: dict[str, int] = {}
    for sid, urls in by_shard.items():
        for u in urls:
            holder_counts[u] = holder_counts.get(u, 0) + 1
    rebuilder = max(holder_counts, key=holder_counts.get)

    local = {sid for sid, urls in by_shard.items() if rebuilder in urls}
    needed = [sid for sid in sorted(present - local)]
    copied_in = []
    for sid in needed:
        if len(local) + len(copied_in) >= 10:
            break
        src = by_shard[sid][0]
        r = http_json(
            "POST",
            f"http://{rebuilder}/admin/ec/copy?volume={vid}&collection={collection}"
            f"&source={src}&shards={sid}&copy_ecx=false&copy_vif=false",
        )
        if r.get("error"):
            raise RuntimeError(f"copy shard {sid}: {r['error']}")
        copied_in.append(sid)

    r = http_json("POST", f"http://{rebuilder}/admin/ec/rebuild?volume={vid}")
    if r.get("error"):
        raise RuntimeError(f"rebuild: {r['error']}")
    rebuilt = r.get("rebuilt_shards", [])
    # the rebuild regenerates every locally-absent shard; keep only the
    # truly-missing ones — drop copied-in temporaries AND regenerated
    # duplicates of shards still live elsewhere (prepareDataToRecover
    # cleanup, command_ec_rebuild.go:187)
    to_drop = sorted((set(copied_in) | set(rebuilt)) - set(missing))
    if to_drop:
        shards = ",".join(str(s) for s in to_drop)
        http_json(
            "POST",
            f"http://{rebuilder}/admin/ec/delete_shards?volume={vid}&shards={shards}",
        )
    http_json("POST", f"http://{rebuilder}/admin/ec/mount?volume={vid}")
    return {
        "volume": vid,
        "rebuilt": sorted(set(rebuilt) & set(missing)),
        "rebuilder": rebuilder,
    }


def ec_decode(env: CommandEnv, vid: int, collection: str = "") -> dict:
    """Decode an erasure-coded volume back into a normal volume
    (shell/command_ec_decode.go): collect the shards onto the node that
    already holds the most, reconstruct .dat/.idx there, then unmount and
    delete every shard cluster-wide."""
    locs = env.ec_shard_locations(vid)
    if not locs:
        raise RuntimeError(f"no ec shards registered for volume {vid}")
    counts: dict[str, int] = {}
    for urls in locs.values():
        for u in urls:
            counts[u] = counts.get(u, 0) + 1
    target = max(counts, key=lambda u: counts[u])
    copied = []
    for sid, urls in sorted(locs.items()):
        if target in urls or not urls:
            continue
        # the target already holds .ecx/.vif (it has shards) — don't
        # re-fetch the index with every shard
        r = http_json(
            "POST",
            f"http://{target}/admin/ec/copy?volume={vid}"
            f"&collection={collection}&shards={sid}&source={urls[0]}"
            f"&copy_ecx=false&copy_vif=false",
        )
        if r.get("error"):
            raise RuntimeError(f"collect shard {sid}: {r['error']}")
        copied.append(sid)
    r = http_json(
        "POST",
        f"http://{target}/admin/ec/to_volume?volume={vid}"
        f"&collection={collection}",
    )
    if r.get("error"):
        raise RuntimeError(f"decode on {target}: {r['error']}")
    # retire the shards everywhere (the target already dropped its EC
    # registration and files during the swap). The decode has committed,
    # so an unreachable holder must not abort the loop — report it.
    retire_errors = []
    for url in counts:
        if url == target:
            continue
        sids = ",".join(str(s) for s, urls in locs.items() if url in urls)
        for ep in (
            f"http://{url}/admin/ec/unmount?volume={vid}",
            f"http://{url}/admin/ec/delete_shards?volume={vid}"
            f"&collection={collection}&shards={sids}",
        ):
            try:
                rr = http_json("POST", ep)
                if rr.get("error"):
                    retire_errors.append(f"{url}: {rr['error']}")
            except Exception as e:  # noqa: BLE001 — keep retiring others
                retire_errors.append(f"{url}: {e}")
    out = {
        "volume": vid,
        "decoded_on": target,
        "collected_shards": copied,
        "dat_size": r.get("dat_size"),
        "file_count": r.get("file_count"),
    }
    if retire_errors:
        out["retire_errors"] = retire_errors
    return out


def ec_balance(env: CommandEnv, collection: str = "") -> dict:
    """command_ec_balance.go: even out shard counts across servers."""
    nodes = [n["url"] for n in env.data_nodes()]
    if not nodes:
        return {"moves": []}
    # collect all ec volumes
    vids = set()
    for n in env.data_nodes():
        st = env.node_status(n["url"])
        for s in st.get("ec", []):
            vids.add(s["id"])
    moves = []
    for vid in sorted(vids):
        by_shard = env.ec_shard_locations(vid)
        counts = {u: 0 for u in nodes}
        holders: dict[int, str] = {}
        for sid, urls in by_shard.items():
            if urls:
                holders[sid] = urls[0]
                counts[urls[0]] = counts.get(urls[0], 0) + 1
        target = -(-len(holders) // len(nodes))  # ceil
        for sid, holder in sorted(holders.items()):
            if counts[holder] <= target:
                continue
            dest = min(counts, key=counts.get)
            if counts[dest] >= target or dest == holder:
                continue
            r = http_json(
                "POST",
                f"http://{dest}/admin/ec/copy?volume={vid}&collection={collection}"
                f"&source={holder}&shards={sid}",
            )
            if r.get("error"):
                continue
            http_json("POST", f"http://{dest}/admin/ec/mount?volume={vid}")
            http_json(
                "POST",
                f"http://{holder}/admin/ec/delete_shards?volume={vid}&shards={sid}",
            )
            counts[holder] -= 1
            counts[dest] += 1
            moves.append({"vid": vid, "shard": sid, "from": holder, "to": dest})
    return {"moves": moves}


# -- replication and moves (command_volume_fix_replication.go,
#    command_volume_copy.go, command_volume_move.go, ...) -------------------
def volume_fix_replication(env: CommandEnv) -> dict:
    """command_volume_fix_replication.go: re-replicate under-replicated
    volumes by copying the .dat/.idx to a fresh server."""
    fixed = []
    seen: dict[int, dict] = {}
    for v in volume_list(env):
        seen.setdefault(v["id"], {"replicas": [], "rp": v["replica_placement"],
                                  "collection": v.get("collection", "")})
        seen[v["id"]]["replicas"].append(v["server"])
    nodes = [n["url"] for n in env.data_nodes()]
    for vid, info in seen.items():
        want = ReplicaPlacement.from_byte(info["rp"]).copy_count()
        have = len(info["replicas"])
        if have >= want:
            continue
        candidates = [n for n in nodes if n not in info["replicas"]]
        for target in candidates[: want - have]:
            src = info["replicas"][0]
            if _copy_volume(env, vid, src, target, info["collection"]):
                fixed.append({"vid": vid, "to": target})
    return {"fixed": fixed}


def _copy_volume(env: CommandEnv, vid: int, source: str, target: str,
                 collection: str = "") -> bool:
    """VolumeCopy: the target pulls .dat/.idx from the source and loads."""
    r = http_json(
        "POST",
        f"http://{target}/admin/volume_copy?volume={vid}&source={source}"
        f"&collection={collection}",
    )
    return not r.get("error")


def volume_copy(env: CommandEnv, vid: int, target: str, source: str = "") -> dict:
    """Add a replica: copy a volume to target without deleting the source
    (command_volume_copy.go)."""
    locs = env.volume_locations(vid)
    if not locs:
        raise RuntimeError(f"volume {vid} has no locations")
    if source and source not in locs:
        raise RuntimeError(f"{source} does not hold volume {vid}")
    source = source or locs[0]
    if target in locs:
        raise RuntimeError(f"{target} already holds volume {vid}")
    collection = _volume_collection(env, vid)
    if not _copy_volume(env, vid, source, target, collection):
        raise RuntimeError(f"copy {vid} {source}→{target} failed")
    return {"volume": vid, "copied_from": source, "to": target}


def volume_unmount(env: CommandEnv, vid: int, node: str) -> dict:
    """Stop serving a volume, keep its files (command_volume_unmount.go)."""
    r = http_json("POST", f"http://{node}/admin/volume_unmount?volume={vid}")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return r


def volume_mount(env: CommandEnv, vid: int, node: str) -> dict:
    """(Re)load a volume from the node's disk (command_volume_mount.go)."""
    r = http_json("POST", f"http://{node}/admin/volume_mount?volume={vid}")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return r


def volume_configure_replication(env: CommandEnv, vid: int, replication: str) -> dict:
    """Rewrite a volume's replica placement on every replica
    (command_volume_configure_replication.go)."""
    locs = env.volume_locations(vid)
    if not locs:
        raise RuntimeError(f"volume {vid} has no locations")
    results = []
    for loc in locs:
        r = http_json("POST", f"http://{loc}/admin/volume_configure_replication"
                              f"?volume={vid}&replication={replication}")
        if r.get("error"):
            raise RuntimeError(f"{loc}: {r['error']}")
        results.append({"server": loc} | r)
    return {"configured": results}


def volume_tier_upload(env: CommandEnv, vid: int, endpoint: str, bucket: str,
                       keep_local: bool = False, backend: str = "") -> dict:
    """Move a sealed volume's .dat to an S3-compatible tier
    (command_volume_tier_upload.go). One replica uploads the bytes; the
    others verify that object and point their .tier descriptor at it."""
    locs = env.volume_locations(vid)
    if not locs:
        raise RuntimeError(f"volume {vid} not found")
    results = []
    for i, loc in enumerate(locs):
        q = urllib.parse.urlencode({
            "volume": vid, "endpoint": endpoint, "bucket": bucket,
            "keepLocal": "true" if keep_local else "false",
            "skipUpload": "true" if i > 0 else "false", "backend": backend})
        r = http_json("POST", f"http://{loc}/admin/tier_upload?{q}", timeout=600)
        if r.get("error"):
            raise RuntimeError(f"tier upload {vid} on {loc}: {r['error']}")
        results.append({"server": loc} | r)
    return {"tiered": results}


def volume_tier_download(env: CommandEnv, vid: int) -> dict:
    """Fetch a tiered volume's .dat back to local disk on every replica
    (command_volume_tier_download.go)."""
    results = []
    for loc in env.volume_locations(vid):
        r = http_json("POST", f"http://{loc}/admin/tier_download?volume={vid}", timeout=600)
        if r.get("error"):
            raise RuntimeError(f"tier download {vid} on {loc}: {r['error']}")
        results.append({"server": loc} | r)
    return {"downloaded": results}


def volume_server_leave(env: CommandEnv, node: str) -> dict:
    """Deregister a volume server now (command_volume_server_leave.go)."""
    r = http_json("POST", f"http://{node}/admin/server_leave")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return r


def volume_move(env: CommandEnv, vid: int, target: str, source: str = "") -> dict:
    """Move one replica: copy to target, then delete at the source
    (command_volume_move.go); the instant delta beats keep the master's
    lookups right throughout."""
    locs = env.volume_locations(vid)
    if not locs:
        raise RuntimeError(f"volume {vid} has no locations")
    source = source or locs[0]
    if source not in locs:
        raise RuntimeError(f"{source} does not hold volume {vid}")
    if target in locs:
        raise RuntimeError(f"{target} already holds volume {vid}")
    collection = _volume_collection(env, vid)
    if not _copy_volume(env, vid, source, target, collection):
        raise RuntimeError(f"copy {vid} {source}→{target} failed")
    r = http_json("POST", f"http://{source}/admin/delete_volume?volume={vid}")
    if r.get("error"):
        raise RuntimeError(f"delete {vid} on {source}: {r['error']}")
    return {"vid": vid, "from": source, "to": target}


# -- balance and evacuate (command_volume_balance.go,
#    command_volume_server_evacuate.go) ---------------------------------------
def _balance_plan(volumes: list[dict], nodes: list[dict],
                  collection: Optional[str]) -> list[dict]:
    """Greedy move plan toward count/capacity parity, the reference's
    balanceVolumeServers score ``count / maxCount``
    (command_volume_balance.go:124-170): move from the fullest ratio to
    the emptiest until within one volume of ideal."""
    caps = {n["url"]: max(n.get("max", 1), 1) for n in nodes}
    held: dict[str, set[int]] = {n["url"]: set() for n in nodes}
    movable: dict[str, list[dict]] = {n["url"]: [] for n in nodes}
    for v in volumes:
        if v["server"] not in held:
            continue
        held[v["server"]].add(v["id"])
        if collection is None or v.get("collection", "") == collection:
            movable[v["server"]].append(v)
    plan = []
    counts = {u: len(vs) for u, vs in held.items()}
    for _ in range(1000):  # a hard stop; each round moves one volume
        ratios = {u: counts[u] / caps[u] for u in counts}
        src = max(ratios, key=ratios.get)
        dsts = sorted(ratios, key=ratios.get)
        moved = False
        for dst in dsts:
            # a move must strictly narrow the spread
            if dst == src or ratios[src] - ratios[dst] <= 1.0 / caps[src]:
                break
            cand = next((v for v in movable[src] if v["id"] not in held[dst]), None)
            if cand is None:
                continue
            plan.append({"vid": cand["id"], "from": src, "to": dst})
            movable[src].remove(cand)
            held[src].discard(cand["id"])
            held[dst].add(cand["id"])
            movable[dst].append(cand)
            counts[src] -= 1
            counts[dst] += 1
            moved = True
            break
        if not moved:
            break
    return plan


def _heat_balance_plan(volumes: list[dict], nodes: list[dict]) -> list[dict]:
    """Move replicas off hot nodes. A node's heat is the sum of its
    replicas' read + write EWMA heat (the heartbeat fields); while the
    hottest node carries more than 1.1x the mean, move its hottest movable
    volume to the coldest node without a replica of it. The JAX package's
    own policy beside the reference's count balance."""
    urls = [n["url"] for n in nodes]
    if len(urls) < 2:
        return []
    held: dict[str, set[int]] = {u: set() for u in urls}
    movable: dict[str, list[dict]] = {u: [] for u in urls}
    vheat: dict[tuple[str, int], float] = {}
    for v in volumes:
        u = v["server"]
        if u not in held:
            continue
        held[u].add(v["id"])
        movable[u].append(v)
        vheat[(u, v["id"])] = v.get("read_heat", 0.0) + v.get("write_heat", 0.0)
    heat = {u: sum(vheat.get((u, vid), 0.0) for vid in held[u]) for u in urls}
    plan: list[dict] = []
    for _ in range(100):  # a hard stop; each round moves one volume
        mean = sum(heat.values()) / len(heat)
        src = max(heat, key=heat.get)
        if mean <= 0.0 or heat[src] <= 1.1 * mean:
            break  # within 10 % of even
        moved = False
        for cand in sorted(movable[src], key=lambda v: vheat.get((src, v["id"]), 0.0),
                           reverse=True):
            h = vheat.get((src, cand["id"]), 0.0)
            if h <= 0.0:
                break  # only cold volumes left on the hot node
            dsts = sorted((u for u in urls if u != src and cand["id"] not in held[u]),
                          key=heat.get)
            if not dsts:
                continue
            dst = dsts[0]
            # only a move that cools the hottest node by >= 10 %: one hot
            # volume swapped between nodes would be churn
            if max(heat[src] - h, heat[dst] + h) > 0.9 * heat[src]:
                continue
            plan.append({"vid": cand["id"], "from": src, "to": dst, "heat": round(h, 3)})
            movable[src].remove(cand)
            held[src].discard(cand["id"])
            held[dst].add(cand["id"])
            movable[dst].append(cand)
            vheat[(dst, cand["id"])] = h
            heat[src] -= h
            heat[dst] += h
            moved = True
            break
        if not moved:
            break
    return plan


def volume_balance(env: CommandEnv, collection: Optional[str] = None,
                   apply: bool = True, heat: bool = False) -> dict:
    """Even out volume counts per server capacity (command_volume_balance.go);
    ``apply=False`` returns the plan only, ``heat=True`` balances EWMA heat
    instead of counts."""
    if heat:
        plan = _heat_balance_plan(volume_list(env), env.data_nodes())
    else:
        plan = _balance_plan(volume_list(env), env.data_nodes(), collection)
    moved = []
    skipped = []
    if apply:
        for m in plan:
            # check each move against fresh state: an earlier move or a
            # node's death can void later entries of the plan
            live = {n["url"] for n in env.data_nodes()}
            locs = env.volume_locations(m["vid"])
            if m["from"] not in live or m["to"] not in live:
                skipped.append({**m, "reason": "source or target node died"})
                continue
            if m["from"] not in locs:
                skipped.append({**m, "reason": f"{m['from']} no longer holds volume"})
                continue
            if m["to"] in locs:
                skipped.append({**m, "reason": f"{m['to']} already holds volume"})
                continue
            # sweedlint: ok maintenance-without-interlock operator-invoked one-shot rebalance; the operator holding the admin lock is the interlock
            volume_move(env, m["vid"], m["to"], m["from"])
            moved.append(m)
    return {"plan": plan, "moved": moved, "skipped": skipped}


def volume_server_evacuate(env: CommandEnv, server: str, apply: bool = True) -> dict:
    """Move every volume and EC shard off one server so that it can be
    retired (command_volume_server_evacuate.go)."""
    nodes = [n for n in env.data_nodes() if n["url"] != server]
    if not nodes:
        raise RuntimeError("no other servers to evacuate to")
    st = env.node_status(server)
    held_elsewhere: dict[int, set[str]] = {}
    for v in volume_list(env):
        held_elsewhere.setdefault(v["id"], set()).add(v["server"])
    counts = {n["url"]: n.get("volumes", 0) for n in nodes}
    moves, ec_moves = [], []
    for v in st.get("volumes", []):
        vid = v["id"]
        targets = sorted((u for u in counts if u not in held_elsewhere.get(vid, ())),
                         key=counts.get)
        if not targets:
            raise RuntimeError(f"no target free of volume {vid}")
        if apply:
            # sweedlint: ok maintenance-without-interlock operator-driven drain of a retiring node; pausing on load would strand the evacuation half done
            volume_move(env, vid, targets[0], server)
        counts[targets[0]] += 1
        moves.append({"vid": vid, "to": targets[0]})
    for s in st.get("ec", []):
        vid = s["id"]
        sids = [i for i in range(TOTAL_SHARDS) if s["ec_index_bits"] & (1 << i)]
        target = min(counts, key=counts.get)
        counts[target] += 1  # spread successive shard groups over the nodes
        if apply:
            shard_csv = ",".join(map(str, sids))
            r = http_json("POST", f"http://{target}/admin/ec/copy?volume={vid}"
                                  f"&source={server}&shards={shard_csv}"
                                  f"&collection={s.get('collection', '')}")
            if r.get("error"):
                raise RuntimeError(f"ec copy {vid}: {r['error']}")
            http_json("POST", f"http://{target}/admin/ec/mount?volume={vid}")
            http_json("POST", f"http://{server}/admin/ec/delete_shards?volume={vid}"
                              f"&shards={shard_csv}")
            http_json("POST", f"http://{server}/admin/ec/unmount?volume={vid}")
        ec_moves.append({"vid": vid, "shards": sids, "to": target})
    return {"volumes": moves, "ec": ec_moves}


# -- trace (the collector over the daemons' span rings) -----------------------
def trace_collect(env: CommandEnv, trace_id: str) -> dict:
    """One distributed trace, assembled from every daemon's span ring (weed
    shell has no such command; the JAX package's collector).

    Asks the master, every volume server of the topology and the filer
    (``/_debug/traces``: the filer's own routes keep user paths free).
    A daemon that does not answer is listed and contributes nothing: a
    partial tree still renders, its orphan spans promoted to roots."""
    endpoints = [f"http://{env.master}/debug/traces"]
    try:
        endpoints += [f"http://{n['url']}/debug/traces" for n in env.data_nodes()]
    except Exception as e:  # noqa: BLE001 — the master down: the filer may hold the spans
        glog.warning("trace: topology unavailable via %s: %s", env.master, e)
    if env.filer:
        endpoints.append(f"http://{env.filer}/_debug/traces")
    spans: dict[str, dict] = {}  # span id -> span (daemons of one process
    unreachable = []             # share a ring: each span once)
    for url in endpoints:
        try:
            r = http_json("GET", f"{url}?trace={trace_id}")
        except Exception:  # noqa: BLE001 — a daemon down is reported, not fatal
            unreachable.append(url)
            continue
        for s in r.get("spans", []):
            spans.setdefault(s["span_id"], s)
    return {
        "trace_id": trace_id,
        "span_count": len(spans),
        "daemons_queried": len(endpoints),
        "unreachable": unreachable,
        "tree": format_tree(assemble_tree(list(spans.values()))),
    }


# -- volume.fsck (command_volume_fsck.go) --------------------------------------
_PAGE = 1000  # listing page size of the filer walks


def _walk_filer(filer: str, path: str = "/"):
    """Every file entry (``meta=true``: with chunks) under ``path`` as
    ``(full path, entry)``, recursively, paging through ``lastFileName`` so
    that a huge directory is covered whole. The trailing slash asks for a
    listing; a path without it and ``meta=true`` answers the entry itself."""
    cursor = ""
    while True:
        r = http_json("GET", f"http://{filer}{path.rstrip('/')}/?limit={_PAGE}&meta=true"
                             f"&lastFileName={cursor}")
        entries = r.get("entries", [])
        for e in entries:
            child = (path.rstrip("/") + "/" + e["name"]) or "/"
            if e.get("is_directory"):
                yield from _walk_filer(filer, child)
            else:
                yield child, e
        if len(entries) < _PAGE:
            return
        cursor = r.get("lastFileName", "") or entries[-1]["name"]


def volume_fsck(env: CommandEnv, filer: str, apply: bool = False,
                cutoff_seconds: float = 300.0) -> dict:
    """Orphan needles: in a volume, but referenced by no filer entry
    (command_volume_fsck.go). ``apply`` purges them through the normal
    delete path.

    Race safety (the reference's cutoffTimeNs): the volumes are scanned
    before the filer walk, so a needle uploaded after the scan cannot be
    flagged, and a purge skips any needle appended within
    ``cutoff_seconds``: an upload whose filer entry has not landed yet is
    never deleted."""
    cutoff_ns = (time.time() - cutoff_seconds) * 1e9
    # 1. the volumes' needles first
    volume_needles: list[dict] = []
    for v in volume_list(env):
        r = http_json("GET", f"http://{v['server']}/admin/needle_ids?volume={v['id']}"
                             "&cookies=true")
        for n in r.get("needles", []):
            volume_needles.append({**n, "vid": v["id"], "server": v["server"]})
    # 2. then every fid the filer references
    referenced: dict[int, set[int]] = {}
    for _, e in _walk_filer(filer):
        for c in e.get("chunks", []):
            fid = c.get("file_id", "")
            if "," not in fid:
                continue
            vid_s, rest = fid.split(",", 1)
            try:
                key, _cookie = parse_path(rest)
            except ValueError:
                continue
            referenced.setdefault(int(vid_s), set()).add(key)
    orphans = [{"vid": n["vid"], "key": n["key"], "size": n["size"],
                "cookie": n.get("cookie", 0), "server": n["server"]}
               for n in volume_needles if n["key"] not in referenced.get(n["vid"], set())]
    purged = 0
    if apply:
        for o in orphans:
            info = http_json("GET", f"http://{o['server']}/admin/needle_info"
                                    f"?volume={o['vid']}&key={o['key']}")
            if info.get("append_ns", 0) > cutoff_ns:
                continue  # too fresh: may be an upload in flight
            fid = f"{o['vid']},{format_needle_id_cookie(o['key'], o['cookie'])}"
            status, _ = http_bytes("DELETE", f"http://{o['server']}/{fid}")
            if status in (200, 202, 204):
                purged += 1
    return {"orphans": orphans, "purged": purged}


# -- fs.* (command_fs_*.go) ------------------------------------------------------
def _fs_resolve(env: CommandEnv, path: Optional[str]) -> str:
    """``path`` against the working directory, ``.`` and ``..`` folded."""
    cwd = env.cwd or "/"
    if not path:
        return cwd
    if not path.startswith("/"):
        path = cwd.rstrip("/") + "/" + path
    parts: list[str] = []
    for seg in path.split("/"):
        if seg in ("", "."):
            continue
        if seg == "..":
            if parts:
                parts.pop()
        else:
            parts.append(seg)
    return "/" + "/".join(parts)


def _list_dir(filer: str, path: str) -> list[dict]:
    """A whole directory listing, paging through ``lastFileName`` (one page
    would truncate a huge directory)."""
    cursor = ""
    out: list[dict] = []
    while True:
        r = http_json("GET", f"http://{filer}{path.rstrip('/') or ''}/?limit={_PAGE}"
                             f"&lastFileName={cursor}")
        if r.get("error"):
            raise RuntimeError(r["error"])
        entries = r.get("entries", [])
        out.extend(entries)
        if len(entries) < _PAGE:
            return out
        cursor = r.get("lastFileName", "") or entries[-1]["name"]


def fs_cd(env: CommandEnv, path: str) -> str:
    target = _fs_resolve(env, path)
    r = http_json("GET", f"http://{env.filer}{target}?limit=1")
    if r.get("error") and target != "/":
        raise RuntimeError(f"no such directory {target}")
    env.cwd = target
    return target


def fs_ls(env: CommandEnv, path: Optional[str] = None) -> list[dict]:
    target = _fs_resolve(env, path)
    # meta=true on a path without its trailing slash answers the entry (a
    # file or a directory) as JSON: a bare GET of a file streams its bytes
    r = http_json("GET", f"http://{env.filer}{target}?meta=true")
    if r.get("error"):
        raise RuntimeError(r["error"])
    if "entries" in r:  # "/" keeps its slash: already a listing
        return _list_dir(env.filer, target)
    if not r.get("is_directory"):
        return [r]  # a file
    return _list_dir(env.filer, target)


def fs_pwd(env: CommandEnv) -> str:
    """command_fs_pwd.go."""
    return env.cwd or "/"


def fs_cat(env: CommandEnv, path: str) -> str:
    """A file's content (command_fs_cat.go)."""
    target = _fs_resolve(env, path)
    status, body = http_bytes("GET", f"http://{env.filer}{target}")
    if status != 200:
        raise RuntimeError(f"cat {target}: HTTP {status}")
    return body.decode("utf-8", "replace")


def fs_mv(env: CommandEnv, src: str, dst: str) -> dict:
    """The filer's atomic rename of a file or a whole directory
    (command_fs_mv.go -> AtomicRenameEntry)."""
    s, d = _fs_resolve(env, src), _fs_resolve(env, dst)
    r = http_json("POST", f"http://{env.filer}{s}?mv.to={d}")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return {"moved": s, "to": d}


def fs_meta_cat(env: CommandEnv, path: str) -> dict:
    """One entry's whole metadata (command_fs_meta_cat.go)."""
    target = _fs_resolve(env, path)
    r = http_json("GET", f"http://{env.filer}{target}?meta=true")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return r


def fs_configure(env: CommandEnv, location_prefix: str = "", collection: str = "",
                 replication: str = "", ttl: str = "", fsync: bool = False,
                 apply: bool = False, delete: bool = False) -> dict:
    """Read or change the path-prefix storage rules the filer applies to
    uploads (command_fs_configure.go -> /etc/seaweedfs/filer.conf, which
    the filer reloads when it is written)."""
    status, raw = http_bytes("GET", f"http://{env.filer}{FILER_CONF_PATH}")
    conf = FilerConf.from_bytes(raw) if status == 200 and raw else FilerConf()
    if location_prefix:
        if delete:
            conf.delete_prefix(location_prefix)
        else:
            conf.set_rule(location_prefix, collection=collection,
                          replication=replication, ttl=ttl, fsync=fsync)
        if apply:
            st, _ = http_bytes("PUT", f"http://{env.filer}{FILER_CONF_PATH}",
                               conf.to_bytes())
            if st not in (200, 201):
                raise RuntimeError(f"writing filer.conf: HTTP {st}")
    return conf.to_dict()


def fs_meta_notify(env: CommandEnv, path: Optional[str] = None) -> dict:
    """Publish every entry under ``path`` as a create event to the queue of
    ``notification.toml`` (command_fs_meta_notify.go), which seeds a new
    replication consumer with the existing tree. The events carry whole
    metadata, chunks included (a summary listing has none, and a
    ``Replicator`` would make empty files of it), in the envelope the
    ``NotificationBus`` sends."""
    # imported here, as in the JAX package: the replication package
    # registers its metric families when it loads
    from ..replication.notification import make_queue

    queue = make_queue(load_configuration("notification"))
    if queue is None:
        raise RuntimeError("notification.toml: no queue enabled")
    target = _fs_resolve(env, path)
    probe = http_json("GET", f"http://{env.filer}{target}?meta=true")
    if probe.get("error"):
        raise RuntimeError(f"{target}: {probe['error']}")
    if "entries" not in probe and not probe.get("is_directory"):
        raise RuntimeError(f"{target} is not a directory")
    dirs = files = 0

    def walk(p: str) -> None:
        nonlocal dirs, files
        cursor = ""
        while True:
            r = http_json("GET", f"http://{env.filer}{p.rstrip('/')}/?limit={_PAGE}"
                                 f"&meta=true&lastFileName={cursor}")
            entries = r.get("entries", [])
            for e in entries:
                child = p.rstrip("/") + "/" + e["name"]
                queue.send(child, {"ts_ns": time.time_ns(),
                                   "directory": child.rsplit("/", 1)[0] or "/",
                                   "old_entry": None,
                                   "new_entry": e | {"full_path": child},
                                   "delete_chunks": False})
                if e.get("is_directory"):
                    dirs += 1
                    walk(child)
                else:
                    files += 1
            if len(entries) < _PAGE:
                return
            cursor = r.get("lastFileName", "") or entries[-1]["name"]

    walk(target)
    return {"path": target, "notified_dirs": dirs, "notified_files": files}


def fs_du(env: CommandEnv, path: Optional[str] = None) -> dict:
    """Bytes, files and directories under ``path`` (command_fs_du.go)."""
    target = _fs_resolve(env, path)
    total, files, dirs = 0, 0, 0
    stack = [target]
    while stack:
        p = stack.pop()
        for e in _list_dir(env.filer, p):
            if e.get("is_directory"):
                dirs += 1
                stack.append(p.rstrip("/") + "/" + e["name"])
            else:
                files += 1
                total += e.get("size", 0)
    return {"path": target, "bytes": total, "files": files, "dirs": dirs}


def fs_tree(env: CommandEnv, path: Optional[str] = None) -> str:
    """The directory tree, drawn (command_fs_tree.go)."""
    target = _fs_resolve(env, path)
    lines = [target]

    def rec(p: str, indent: str) -> None:
        entries = _list_dir(env.filer, p)
        for i, e in enumerate(entries):
            last = i == len(entries) - 1
            lines.append(f"{indent}{'└── ' if last else '├── '}{e['name']}"
                         + ("/" if e.get("is_directory") else ""))
            if e.get("is_directory"):
                rec(p.rstrip("/") + "/" + e["name"], indent + ("    " if last else "│   "))

    rec(target, "")
    return "\n".join(lines)


def fs_meta_save(env: CommandEnv, out_path: str, path: Optional[str] = None) -> dict:
    """Every file entry's whole metadata under ``path`` as JSON lines
    (command_fs_meta_save.go; the reference writes protobuf)."""
    target = _fs_resolve(env, path)
    n = 0
    with open(out_path, "w") as f:
        for full, e in _walk_filer(env.filer, target):
            f.write(json.dumps(dict(e, full_path=full)) + "\n")
            n += 1
    return {"saved": n, "file": out_path}


def fs_meta_load(env: CommandEnv, in_path: str) -> dict:
    """Replay a ``fs.meta.save`` dump into the filer
    (command_fs_meta_load.go): entries with their chunks, no data uploaded
    again, through the filer's raw metadata write (``POST
    <path>?meta=true``), so filer.conf reloads and peer signatures take the
    normal path."""
    n = 0
    with open(in_path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            r = http_json("POST", f"http://{env.filer}{d['full_path']}?meta=true",
                          json.dumps(d).encode())
            if r.get("error"):
                raise RuntimeError(f"{d.get('full_path')}: {r['error']}")
            n += 1
    return {"loaded": n}


# -- bucket.* (command_bucket_*.go) ------------------------------------------
BUCKETS_PATH = "/buckets"


def bucket_list(env: CommandEnv) -> list[str]:
    r = http_json("GET", f"http://{env.filer}{BUCKETS_PATH}?limit=10000")
    return [e["name"] for e in r.get("entries", []) if e.get("is_directory")]


def bucket_create(env: CommandEnv, name: str) -> dict:
    r = http_json("POST", f"http://{env.filer}{BUCKETS_PATH}/{name}/?mkdir=true")
    if r.get("error"):
        raise RuntimeError(r["error"])
    return {"created": name}


def bucket_delete(env: CommandEnv, name: str) -> dict:
    status, _ = http_bytes("DELETE", f"http://{env.filer}{BUCKETS_PATH}/{name}?recursive=true")
    if status not in (200, 204):
        raise RuntimeError(f"delete bucket {name}: http {status}")
    return {"deleted": name}


# -- query (the filer's /_query) ---------------------------------------------------
def query(env: CommandEnv, sql: str, path: str, input_format: str = "csv") -> dict:
    """An S3-Select scan of a stored CSV or JSON-lines file (a query path
    `weed/shell` never grew): the filer's ``/_query`` pushes a one-chunk
    plain file down to the volume server holding its needle and scans
    anything else itself, on its device."""
    if not sql:
        raise RuntimeError("query needs a SQL string argument")
    if not path:
        raise RuntimeError("query needs -path=FILE")
    r = http_json("POST", f"http://{env.filer}/_query",
                  {"path": _fs_resolve(env, path), "sql": sql, "input": input_format},
                  timeout=600)
    if r.get("error"):
        raise RuntimeError(r["error"])
    return r


# -- remote.dlq (the replication dead-letter queues) ----------------------------
def remote_dlq(env: CommandEnv, dlq_dir: str, replay: bool = False,
               direction: str = "") -> dict:
    """List, or replay, the replication dead-letter queues under ``dlq_dir``
    (a ``dlq.<direction>.jsonl`` a sync direction, written by
    ``ReplicationController``). Listing is read-only; ``replay`` applies
    each parked event to its recorded target again, and what fails again
    stays parked."""
    from ..replication.controller import DeadLetterQueue  # as make_queue above

    if not dlq_dir:
        raise RuntimeError("remote.dlq needs -dir=DLQ_DIR")
    out: dict = {}
    for fname in sorted(os.listdir(dlq_dir)):
        if not (fname.startswith("dlq.") and fname.endswith(".jsonl")):
            continue
        name = fname[len("dlq."):-len(".jsonl")]
        if direction and name != direction:
            continue
        dlq = DeadLetterQueue(os.path.join(dlq_dir, fname))
        if replay:
            out[name] = dlq.replay()
        else:
            out[name] = {
                "depth": dlq.depth(),
                "entries": [{"path": r.get("path"), "ts_ns": r.get("ts_ns"),
                             "target": r.get("target"), "error": r.get("error"),
                             "parked_unix": r.get("parked_unix")}
                            for r in dlq.entries()],
            }
    return out
