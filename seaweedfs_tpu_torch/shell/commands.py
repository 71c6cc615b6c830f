"""Admin shell commands over the master/volume HTTP surfaces.

The EC subset of `weed/shell/`, ported from the JAX package's shell:
    volume.list, volume.delete, volume.mark (readonly|writable)
    ec.encode   (command_ec_encode.go:55 — readonly → generate → spread;
                 -fleet hands the generate step to the master's scheduler)
    ec.rebuild  (command_ec_rebuild.go:57 — copy ≥k shards → rebuild → mount)
    ec.decode   (command_ec_decode.go — collect shards → to_volume)
    ec.balance  (command_ec_balance.go — even shard spread across servers)
    collection.list / collection.delete, cluster.status, lock / unlock

Every command is a plain function usable programmatically; ``shell.py``
wraps them in the REPL. Each EC step runs on the volume servers' admin
endpoints, where the GF(2^8) product goes through the store's codec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ec.constants import TOTAL_SHARDS
from ..server.http_util import http_json
from ..wdclient import find_reachable_master


@dataclass
class CommandEnv:
    master: str
    token: Optional[str] = None

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


def collection_list(env: CommandEnv) -> list[str]:
    return http_json("GET", f"http://{env.master}/col/list")["collections"]


def collection_delete(env: CommandEnv, name: str) -> dict:
    return http_json("POST", f"http://{env.master}/col/delete?collection={name}")


# -- volume commands ----------------------------------------------------------
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
