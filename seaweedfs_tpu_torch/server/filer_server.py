"""Filer daemon: HTTP file CRUD with auto-chunking over the object store.

The port's copy of the JAX package's ``server/filer_server.py`` (after
`weed/server/filer_server_handlers_*.go`), over the port's master and
volume servers:
    POST/PUT /path  — body split into chunks (default 32MB,
                      `_write_autochunk.go:202 uploadReaderToChunks`): each
                      chunk is assigned + uploaded to volume servers, up to
                      ``write_window`` in flight, then the entry (chunk
                      list) is saved (saveMetaData :129)
    GET  /path      — file: chunk views streamed with a ``read_window``-deep
                      read-ahead, Range supported (a view of part of a
                      plain chunk too large to cache asks the volume
                      server for its bytes only); directory: JSON listing
                      (_read_dir.go)
    HEAD /path      — meta only
    DELETE /path[?recursive=true]

Metadata-level endpoints standing in for the filer gRPC rpcs
(`pb/filer.proto` LookupDirectoryEntry/CreateEntry/AtomicRenameEntry):
    GET    /path?meta=true            — full entry JSON incl. chunk list
    POST   /path?meta=true            — create entry from JSON body
    POST   /path?mv.to=/new/path      — atomic rename
    POST   /path?link.to=/other       — hard link
    DELETE /path?skipChunkPurge=true  — drop meta, keep chunks (multipart)
    GET    /dir/?prefix=x&meta=true   — listing with name-prefix filter
Deleted/overwritten chunk fids are purged from the object store
(filer_deletion.go → operation.DeleteFiles).

Queries: ``POST /_query`` sends a single-chunk plain entry's request to
the volume server holding the needle (the data-local pushdown,
volume_grpc_query.go:12), which scans it on its store's device; other
entries, and a pushdown that fails, are scanned here, as is every
``POST /_select`` (S3 SelectObjectContent, framed as the AWS event
stream). The filer's own scans run on ``query_backend`` (``cuda`` unless
``$SWEED_QUERY_BACKEND`` or the caller says ``cpu``); without a card they
fail naming the device, and never scan on the CPU.

``/_debug/traces`` serves the process's span ring (``stats/trace.py``), and
``/_status`` carries its ``trace``, ``deadline`` and ``sync`` sections.

A sharded fleet (``ring_peers=[...]``, ``filer/ring.py``): each filer owns
the subtrees whose shard key the ring maps to it. Reads of a foreign path
answer 307 to the owner, writes and deletes are proxied there, and spine
dirs (shallower than the shard key) live on every member, their listings
merged across the fleet. ``noRedirect=1`` marks a hop inside the fleet.
``GET /_ring`` reports the layout and ``POST /_reshard?root=&target=&epoch=``
moves a subtree from this filer to another (``filer/reshard.py``).
"""

from __future__ import annotations

import base64
import hashlib
import json
import random
import threading
import time
import urllib.parse
from typing import Optional

from .. import operation
from ..filer.entry import Entry, FileChunk
from ..filer.filechunks import view_from_chunks
from ..filer.filer import Filer
from ..filer.filerstore import NotFoundError, SqliteStore
from ..stats import trace as _trace
from ..util import deadline as _deadline
from ..util import faultpoints, glog
from ..util import hedge as _hedge
from ..util.locks import lock_stats, make_lock
from ..util.parsers import tolerant_ufloat, tolerant_uint
from ..wdclient import MasterClient
from .http_util import (
    SERVING,
    JsonHandler,
    has_dot_segments,
    http_json,
    start_server,
)


class _VidLookup:
    """operation.LookupCache-shaped facade over a wdclient MasterClient."""

    def __init__(self, mc: MasterClient):
        self._mc = mc

    def lookup(self, vid: int) -> list[dict]:
        return [
            {"url": loc.url, "publicUrl": loc.public_url}
            for loc in self._mc.lookup_volume(vid)
        ]

    def invalidate(self, vid: int) -> None:
        self._mc.vid_map.invalidate(vid)


class _FidBatch:
    """Batched fid source for the overlapped write path: each master
    assign(count=n) reserves n consecutive needle keys (the sequencer bumps
    once), handed out as base, base_1 … base_{n-1} — ``_<delta>`` suffix
    fids that parse_path/FileId.parse resolve to key+delta with the base
    cookie (needle.go ParsePath).

    All fids of one batch land on the base fid's volume, so a refill pulls
    ``lanes`` batches (the master's pick_for_write randomizes the volume
    per call) and DEALS them round-robin: consecutive pieces go to
    different volume servers and the write window aggregates their ingest
    bandwidth instead of queueing on one server — one batch per window
    would hand the whole in-flight window to a single volume and measure
    its lock, not the pipeline.

    Auth: master tokens are fid-scoped and cover only the base fid, so
    suffix fids are self-signed with the filer's shared signing key. When
    the cluster enforces auth and this filer holds no signing key, the
    reserved suffixes are unusable — each piece then falls back to its own
    single assign (the skipped needle ids are never written; a sequencer
    gap is harmless)."""

    def __init__(self, fs: "FilerServer", collection: str, replication: str,
                 ttl: str, batch: int, lanes: int = 1):
        self._fs = fs
        self._collection = collection
        self._replication = replication
        self._ttl = ttl
        self._batch = max(1, batch)
        self._lanes = max(1, lanes)
        self._pending: list[operation.Assignment] = []
        self._lock = make_lock("_FidBatch._lock")

    def _one_batch(self) -> list[operation.Assignment]:
        a = operation.assign(
            self._fs.master_url,
            count=self._batch,
            collection=self._collection,
            replication=self._replication,
            ttl=self._ttl,
        )
        got = max(1, a.count)
        usable = got if (not a.auth or self._fs.jwt_signing_key) else 1
        lane = [a]
        for delta in range(1, usable):
            fid = f"{a.fid}_{delta}"
            auth = ""
            if a.auth:
                from ..security import gen_jwt

                auth = gen_jwt(self._fs.jwt_signing_key, fid)
            lane.append(operation.Assignment(
                fid=fid, url=a.url, public_url=a.public_url,
                count=1, auth=auth,
            ))
        return lane

    def next(self) -> operation.Assignment:
        with self._lock:
            if self._pending:
                return self._pending.pop()
        # Refill OUTSIDE the lock: operation.assign is a master RPC, and
        # holding _lock across it would stall every concurrent upload
        # that still has fids in hand.  Two threads racing here both
        # allocate a batch; both batches are kept — fids are cheap and
        # an unused one is simply never written.
        lanes = [self._one_batch() for _ in range(self._lanes)]
        # round-robin deal so neighboring pieces hit distinct
        # volumes; .pop() serves from the end, so build reversed
        dealt = [
            lane[i]
            for i in range(max(len(ln) for ln in lanes))
            for lane in lanes
            if i < len(lane)
        ]
        with self._lock:
            # keep whatever arrived meanwhile; older fids serve first
            self._pending = dealt[::-1] + self._pending
            return self._pending.pop()


class _AssignCoalescer:
    """Single-flight batching of concurrent single-fid assigns: under a
    smallfile write storm every request thread used to fire its own
    ``/dir/assign`` at the master — N round-trips for N needle keys the
    sequencer could have reserved in one bump. Here the first caller in a
    quiet period LEADS: it issues the RPC immediately (an uncontended
    assign pays zero added latency — no timers), and callers that arrive
    while that RPC is in flight queue up; the leader keeps issuing
    ``assign(count=len(queue))`` rounds until the queue is empty.

    Fid fan-out mirrors ``_FidBatch``: the master token covers only the
    base fid, so ``base_<delta>`` suffixes are self-signed with the
    filer's key. When the cluster enforces auth and this filer holds no
    signing key, only the base fid is usable — the leader takes it and
    the other waiters are released to do their own single assigns
    (correct, just uncoalesced).
    """

    def __init__(self, fs: "FilerServer"):
        self._fs = fs
        self._lock = make_lock("_AssignCoalescer._lock")
        self._queues: dict = {}  # key → list of waiter dicts
        self._leading: set = set()  # keys with an RPC loop running

    def assign(self, collection: str, replication: str, ttl: str):
        key = (collection, replication, ttl)
        w = {"evt": threading.Event(), "a": None, "err": None,
             "solo": False, "promote": False}
        with self._lock:
            self._queues.setdefault(key, []).append(w)
            lead = key not in self._leading
            if lead:
                self._leading.add(key)
        if lead:
            self._lead_round(key)
        while True:
            if not w["evt"].wait(timeout=60.0):
                raise RuntimeError("coalesced assign timed out")
            if w["promote"]:
                # leadership handoff: the previous leader served its round
                # and left; we (still unserved) run the next round — no
                # caller ever issues more than one RPC for the group
                w["promote"] = False
                w["evt"].clear()
                self._lead_round(key)
                continue
            break
        if w["err"] is not None:
            raise w["err"]
        if w["solo"]:
            # auth cluster without a filer signing key: suffix fids are
            # unusable, go get a dedicated one
            return operation.assign(
                self._fs.master_url, collection=collection,
                replication=replication, ttl=ttl,
            )
        return w["a"]

    def _lead_round(self, key) -> None:
        collection, replication, ttl = key
        with self._lock:
            waiters = self._queues.pop(key, [])
            if not waiters:
                self._leading.discard(key)
                return
        try:
            a = operation.assign(
                self._fs.master_url, count=len(waiters),
                collection=collection, replication=replication, ttl=ttl,
            )
        except Exception as e:
            for w in waiters:
                w["err"] = e
                w["evt"].set()
            self._handoff(key)
            return
        got = max(1, a.count)
        usable = got if (not a.auth or self._fs.jwt_signing_key) else 1
        usable = min(usable, len(waiters))
        SERVING.note_assign_batch(usable)
        waiters[0]["a"] = a
        waiters[0]["evt"].set()
        for i, w in enumerate(waiters[1:], start=1):
            if i >= usable:
                w["solo"] = True
                w["evt"].set()
                continue
            fid = f"{a.fid}_{i}"
            auth = ""
            if a.auth:
                from ..security import gen_jwt

                auth = gen_jwt(self._fs.jwt_signing_key, fid)
            w["a"] = operation.Assignment(
                fid=fid, url=a.url, public_url=a.public_url,
                count=1, auth=auth,
            )
            w["evt"].set()
        self._handoff(key)

    def _handoff(self, key) -> None:
        """End of a round: pass leadership to a queued waiter, or step
        down. The enqueue in ``assign`` and this check share one lock, so
        a waiter either made this round's grab, gets promoted here, or
        (arriving after the discard) elects itself."""
        with self._lock:
            nxt = self._queues.get(key)
            if not nxt:
                self._queues.pop(key, None)
                self._leading.discard(key)
                return
            nxt[0]["promote"] = True
            nxt[0]["evt"].set()


def _tag_hedge_won() -> None:
    """Tag the request's span: the hedge leg answered first."""
    span = _trace.current_span()
    if span is not None:
        span.tags["hedge"] = "won"


class FilerServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8888,
        master_url: str = "127.0.0.1:9333",
        chunk_size: int = 32 * 1024 * 1024,
        db_path: str = ":memory:",
        collection: str = "",
        replication: str = "",
        jwt_signing_key: str = "",
        jwt_read_key: str = "",
        chunk_cache_dir: str = "",
        chunk_cache_mem_mb: int = 64,
        cipher: bool = False,
        manifest_batch: int = 1000,
        peers: Optional[list[str]] = None,
        meta_log_dir: str = "",
        read_window: int = 4,
        write_window: int = 4,
        query_backend: Optional[str] = None,
        store=None,
        ring_peers: Optional[list[str]] = None,
    ):
        from ..stats.metrics import default_registry, query_stats
        from ..util.chunk_cache import TieredChunkCache

        self._query_stats = query_stats
        # the filer-side scan's device (cuda | cpu); None reads
        # $SWEED_QUERY_BACKEND, else cuda, and never falls back to the CPU
        self.query_backend = query_backend
        self._routes_lock = make_lock("FilerServer._routes_lock")
        self._routes = {"pushdown": 0, "filer_side": 0}

        self.jwt_signing_key = jwt_signing_key
        # volume read gate key (security.toml jwt.signing.read.key — shared
        # with the volume servers, as the reference's filer shares it)
        self.jwt_read_key = jwt_read_key
        self.chunk_cache = TieredChunkCache(
            directory=chunk_cache_dir or None,
            mem_budget=chunk_cache_mem_mb * 1024 * 1024,
        )
        self.metrics = default_registry
        self._req_hist = self.metrics.histogram(
            "filer_request_seconds", "filer request latency"
        )
        self.host, self.port = host, port
        # comma-separated master seeds (HA: filer.go takes -master lists);
        # operation calls go to the live leader via master_url (property)
        self.master_seeds = [m.strip() for m in master_url.split(",")
                             if m.strip()]
        self.chunk_size = chunk_size
        self.collection = collection
        self.replication = replication
        self.cipher = cipher
        self.manifest_batch = manifest_batch
        # single-flight batcher for the per-request assign storm
        self._assign_coalescer = _AssignCoalescer(self)
        # data-plane pipeline depths (util/pipeline.py): N-deep chunk
        # read-ahead on GET, N uploads in flight on PUT; 1 = serial. Peak
        # extra memory per request is window × chunk_size
        self.read_window = max(1, read_window)
        self.write_window = max(1, write_window)
        if not meta_log_dir and db_path not in ("", ":memory:"):
            # persist beside the store, but per-filer: two filers SHARING one
            # store (a supported topology) must not interleave segments or
            # collide on seq numbering in a common directory
            meta_log_dir = f"{db_path}.metalog.{port}"
        elif not meta_log_dir and store is not None:
            # networked store (redis/sql): the store is durable, so the meta
            # log must be too — peers resume from offsets saved in the store's
            # KV, which would dangle against a fresh in-memory log
            meta_log_dir = f"./filer.metalog.{port}"
        self.filer = Filer(
            store=store or SqliteStore(db_path),
            chunk_purger=self._purge_chunks,
            meta_log_dir=meta_log_dir or None,
        )
        self.filer.chunk_resolver = self._resolve_chunks
        from ..filer.filer_conf import FILER_CONF_PATH, FilerConf

        self._conf_path = FILER_CONF_PATH
        self.filer_conf = FilerConf()
        # wdclient keeps the vid map warm off the master's KeepConnected
        # feed (wdclient/masterclient.go); hot-path reads never block on a
        # master round-trip unless the vid is genuinely unknown
        self._master_client = MasterClient(
            self.master_seeds, f"filer@{host}:{port}"
        ).start()
        self._lookup = _VidLookup(self._master_client)
        self._load_filer_conf()
        self._srv = None
        # cluster-sync loop-prevention signature (filer.go Signature),
        # PERSISTED in the store: a restarted cluster must keep the
        # signature its replicated writes already carry on the peer, or the
        # peer's reverse syncer stops recognizing them and echoes old
        # events back after a datacenter bounce
        sig_raw = self.filer.store.kv_get(b"filer.signature")
        if sig_raw:
            self.signature = int(sig_raw)
        else:
            self.signature = random.getrandbits(31)
            self.filer.store.kv_put(
                b"filer.signature", str(self.signature).encode()
            )
        # register our signature in the store so peers sharing it can tell
        # (meta_aggregator.go:43 store-sharing detection)
        from ..filer.meta_aggregator import PEER_SIG_PREFIX, MetaAggregator

        self.filer.store.kv_put(
            PEER_SIG_PREFIX + str(self.signature).encode(),
            f"{host}:{port}".encode(),
        )
        self.meta_aggregator = MetaAggregator(
            self.filer, f"{host}:{port}", peers or []
        )
        # sharded fleet (filer/ring.py): ring_peers is the FULL member
        # list including this filer. With <2 members the ring is inert and
        # every path below serves exactly as before — single-filer
        # clusters never see a redirect, proxy, or fan-out.
        from ..filer.ring import FilerRing

        self.ring = FilerRing(
            list(ring_peers or []), self_url=f"{host}:{port}"
        )
        # fid-range leases (cluster/fid_lease.py): single-fid assigns mint
        # locally from a master-granted key range; per-request coalesced
        # assigns remain the fallback on any lease failure
        from ..cluster.fid_lease import LeasedFidSource

        sign_fn = None
        if jwt_signing_key:
            from ..security import gen_jwt

            sign_fn = lambda fid: gen_jwt(jwt_signing_key, fid)  # noqa: E731
        self._fid_leases = LeasedFidSource(
            self._lease_grant, self._assign_coalescer.assign, sign_fn
        )
        # chunk-fetch latency: its p99 is the hedge trigger delay (util/
        # hedge.py pick_delay_s) — hedging self-tunes to observed tails
        self._chunk_hist = self.metrics.histogram(
            "filer_chunk_fetch_seconds",
            "filer→volume chunk fetch latency (hedge delay source)",
        )

    @property
    def master_url(self) -> str:
        """The master to talk to RIGHT NOW: the leader the KeepConnected
        feed discovered, else a briefly-cached probe through the seeds — a
        filer must survive its first-listed master dying (wdclient
        masterclient.go tryAllMasters), including the startup/blip windows
        where the background loop hasn't re-discovered a leader yet."""
        mc = getattr(self, "_master_client", None)
        if mc is not None and mc.current_master:
            return mc.current_master
        if len(self.master_seeds) == 1:
            return self.master_seeds[0]
        from ..wdclient import find_reachable_master

        now = time.monotonic()
        cached = getattr(self, "_seed_pick_", None)
        if cached is None or now - cached[1] > 2.0:
            cached = (find_reachable_master(self.master_seeds, 1.0), now)
            self._seed_pick_ = cached
        return cached[0]

    def _load_filer_conf(self) -> None:
        """Read /etc/seaweedfs/filer.conf through the filer and swap the
        active rule set (filer.go LoadFilerConf — reference loads at startup
        and on every change to the conf entry)."""
        from ..filer.filer_conf import FilerConf

        try:
            entry = self.filer.find_entry(self._conf_path)
            data = self._read_range(entry, 0, entry.file_size())
        except NotFoundError:
            data = b""
        except Exception:
            return  # unreadable conf keeps the last good rule set
        self.filer_conf = FilerConf.from_bytes(data)

    def _maybe_reload_conf(self, *paths: str) -> None:
        if any(p == self._conf_path for p in paths):
            self._load_filer_conf()

    def _lease_grant(self, collection: str, replication: str, ttl: str,
                     count: int) -> dict:
        """The fid-lease RPC: one master round trip reserves ``count``
        needle keys this filer mints from locally."""
        qs = urllib.parse.urlencode({
            "client": self.url, "count": str(count),
            "collection": collection, "replication": replication,
            "ttl": ttl,
        })
        return http_json(
            "POST", f"http://{self.master_url}/dir/fid_lease?{qs}"
        )

    def _assign_one(self, collection: str, replication: str, ttl: str):
        """Single-fid source for the write path: leased local minting
        first (zero master round-trips while a range is live), coalesced
        per-request assigns as the always-correct fallback."""
        return self._fid_leases.assign(collection, replication, ttl)

    # -- sharded fleet: ownership gates (filer/ring.py) ----------------------
    # With <2 ring members every gate below returns None immediately and
    # the daemon behaves exactly as the single-filer build. With a fleet:
    # reads REDIRECT foreign paths (307 — bodies can be huge and a GET is
    # safe to re-issue), writes PROXY (a consumed stream can't replay a
    # 307), and spine dirs — shallower than the shard key — fan out so
    # `ls /bucket` stays correct with children living on every member.
    # ``noRedirect=1`` marks intra-fleet hops and breaks forwarding loops.

    @staticmethod
    def _fwd_query(q) -> str:
        qs = urllib.parse.urlencode({**q, "noRedirect": "1"})
        return f"?{qs}" if qs else ""

    def _redirect_to_owner(self, h, path, q, owner: str):
        h.extra_headers = {
            "Location": f"http://{owner}{path}{self._fwd_query(q)}"
        }
        return 307, {"redirect": owner}

    def _ring_point_gate(self, h, path, q):
        """Ownership gate for point lookups (GET/HEAD of one path):
        None → serve locally, else a 307 to the owner. Spine paths are
        served by every member; a locally-missing one still redirects to
        its owner in case it's a file AT spine depth (owner-placed)."""
        if not self.ring.active or q.get("noRedirect") == "1":
            return None
        p = urllib.parse.unquote(path).rstrip("/") or "/"
        if self.ring.is_spine(p):
            try:
                self.filer.find_entry(p)
                return None  # the local replica answers
            except NotFoundError:
                pass
        owner = self.ring.owner(p)
        if owner != self.ring.self_url:
            return self._redirect_to_owner(h, path, q, owner)
        return None

    def _ring_read_gate(self, h, path, q):
        g = self._ring_point_gate(h, path, q)
        if g is not None:
            return g
        if not self.ring.active or q.get("noRedirect") == "1":
            return None
        p = urllib.parse.unquote(path).rstrip("/") or "/"
        if not self.ring.is_spine(p):
            return None
        try:
            entry = self.filer.find_entry(p)
        except NotFoundError:
            return None
        if entry.is_directory and not (
            q.get("meta") == "true" and not path.endswith("/")
        ):
            return self._spine_list_merged(h, path, q, p)
        return None

    def _spine_list_merged(self, h, path, q, p):
        """Spine dir listing: shard roots live on their owners and deeper
        spine dirs on everyone, so the children of a spine dir are spread
        across the fleet — fan out with noRedirect, merge by name (prefer
        the directory copy), present one sorted view. Mirrors
        RingFilerClient.list so dumb and smart clients see identical
        listings."""
        limit = self._qint(q, "limit", 1000)
        merged: dict[str, dict] = {}

        def fold(entries):
            for e in entries:
                name = e.get("name", "")
                prev = merged.get(name)
                if prev is None or (
                    not prev.get("is_directory") and e.get("is_directory")
                ):
                    merged[name] = e

        status, local = self._h_read_inner(
            h, path, dict(q, noRedirect="1"), b""
        )
        if status == 200 and isinstance(local, dict):
            fold(local.get("entries", []))
        target = path if path.endswith("/") else path + "/"
        qs = self._fwd_query(q)
        for m in self.ring.members():
            if m == self.ring.self_url:
                continue
            try:
                r = http_json("GET", f"http://{m}{target}{qs}")
                fold(r.get("entries", []))
            except Exception:  # sweedlint: ok broad-except a down peer degrades the merged view, never 500s it
                pass
        entries = [merged[k] for k in sorted(merged)][:limit]
        return 200, {
            "path": p,
            "entries": entries,
            "lastFileName": entries[-1]["name"] if entries else "",
        }

    def _ring_write_gate(self, h, path, q, rfile, length):
        """Writes PROXY to the owner — the request body is a consumed
        stream, which a 307 cannot replay. Spine dir creates replicate to
        every member; cross-shard renames are refused here (the ring-aware
        client decomposes them into copy + metadata-only delete)."""
        if not self.ring.active or q.get("noRedirect") == "1":
            return None
        parsed = urllib.parse.unquote(path)
        p = parsed.rstrip("/") or "/"
        if q.get("mv.to"):
            if self.ring.owner(q["mv.to"].rstrip("/") or "/") != self.ring.owner(p):
                return 400, {
                    "error": "cross-shard rename: use a ring-aware client"
                }
            if self.ring.owner(p) != self.ring.self_url:
                return self._proxy_write(
                    h, path, q, self.ring.owner(p), rfile, length
                )
            return None
        if self.ring.is_spine(p):
            from .http_util import http_bytes

            ct = h.headers.get("Content-Type", "") or ""
            body = None
            is_dir = parsed.endswith("/")
            if q.get("meta") == "true":
                # a meta=true entry at spine depth may be a FILE (owner-
                # placed) — sniff the small body to tell; every branch
                # that consumed it finishes from the buffer
                body = rfile.read(length) if length else b""
                try:
                    is_dir = bool(json.loads(body).get("is_directory"))
                except (ValueError, AttributeError):
                    is_dir = parsed.endswith("/")
            if is_dir:
                # spine DIR create (mkdir / meta entry): every member
                # holds a replica so its listings can fan out from it
                if body is None:
                    body = rfile.read(length) if length else b""
                st, payload = self._h_write_inner(
                    h, path, dict(q, noRedirect="1"), body
                )
                qs = self._fwd_query(q)
                for m in self.ring.members():
                    if m == self.ring.self_url:
                        continue
                    try:
                        http_bytes(
                            h.command, f"http://{m}{path}{qs}", body=body,
                            headers={"Content-Type": ct} if ct else None,
                        )
                    except OSError:
                        # a joining/down member backfills via reshard; the
                        # merged listing hides the gap meanwhile
                        pass
                return st, payload
            if body is not None:
                # buffered meta=true FILE entry at spine depth
                owner = self.ring.owner(p)
                if owner == self.ring.self_url:
                    return self._h_write_inner(
                        h, path, dict(q, noRedirect="1"), body
                    )
                url = f"http://{owner}{path}{self._fwd_query(q)}"
                try:
                    st, data = http_bytes(
                        h.command, url, body=body,
                        headers={"Content-Type": ct} if ct else None,
                    )
                except OSError as e:
                    return 502, {"error": f"owner {owner} unreachable: {e}"}
                h.extra_headers = {"Content-Type": "application/json"}
                return st, data
            # plain FILE stream at spine depth: owner-placed, body untouched
        owner = self.ring.owner(p)
        if owner != self.ring.self_url:
            return self._proxy_write(h, path, q, owner, rfile, length)
        return None

    def _proxy_write(self, h, path, q, owner, rfile, length):
        from .http_util import CountedReader, http_stream_request

        fwd = {
            k: v for k, v in h.headers.items()
            if k.lower() == "content-type"
            or k.title().startswith("Seaweed-")
        }
        url = f"http://{owner}{path}{self._fwd_query(q)}"
        try:
            status, data, _ = http_stream_request(
                h.command, url, CountedReader(rfile, length), length,
                headers=fwd,
            )
        except OSError as e:
            return 502, {"error": f"owner {owner} unreachable: {e}"}
        h.extra_headers = {"Content-Type": "application/json"}
        return status, data

    def _ring_delete_gate(self, h, path, q):
        if not self.ring.active or q.get("noRedirect") == "1":
            return None
        p = urllib.parse.unquote(path).rstrip("/") or "/"
        if self.ring.is_spine(p):
            local_is_dir = False
            try:
                local_is_dir = self.filer.find_entry(p).is_directory
            except NotFoundError:
                pass
            if local_is_dir:
                return self._spine_delete_fanout(h, path, q)
        owner = self.ring.owner(p)
        if owner != self.ring.self_url:
            return self._proxy_delete(h, path, q, owner)
        return None

    def _spine_delete_fanout(self, h, path, q):
        """Delete a replicated spine dir on every member. Success wants
        RingFilerClient.delete's shape: worst non-404 status wins; a 404
        only surfaces when NOBODY had the entry."""
        from .http_util import http_bytes

        p = urllib.parse.unquote(path).rstrip("/") or "/"
        qs = self._fwd_query(q)
        worst, purged = 0, 0
        for m in self.ring.members():
            if m == self.ring.self_url:
                st, payload = self._h_delete_inner(
                    h, path, dict(q, noRedirect="1"), b""
                )
            else:
                try:
                    st, raw = http_bytes("DELETE", f"http://{m}{path}{qs}")
                    try:
                        payload = json.loads(raw)
                    except ValueError:
                        payload = {}
                except OSError:
                    st, payload = 502, {}
            if st == 404:
                continue
            if st < 400 and isinstance(payload, dict):
                purged += payload.get("purged_chunks", 0)
            worst = max(worst, st)
        if worst == 0:
            return 404, {"error": f"{p} not found"}
        if worst < 400:
            return 200, {"purged_chunks": purged}
        return worst, {"error": "spine delete partially failed"}

    def _proxy_delete(self, h, path, q, owner):
        from .http_util import http_bytes

        try:
            status, data = http_bytes(
                "DELETE", f"http://{owner}{path}{self._fwd_query(q)}"
            )
        except OSError as e:
            return 502, {"error": f"owner {owner} unreachable: {e}"}
        h.extra_headers = {"Content-Type": "application/json"}
        return status, data

    def _purge_chunks(self, fids: list[str]) -> None:
        t = threading.Thread(
            target=operation.delete_files,
            args=(self.master_url, fids),
            kwargs={"jwt_key": self.jwt_signing_key},
            daemon=True,
        )
        t.start()

    # -- meta subscribe / kv / status (filer_pb rpc analogs) -----------------
    @staticmethod
    def _qint(q, key, default):
        """Tolerant query-int: garbage and negatives fall back to the
        default, the way the reference's handlers treat strconv.Atoi
        failures — a client's bad parameter must not surface as the
        daemon's 500 (see util.parsers for the full rationale)."""
        return tolerant_uint(q.get(key, default), default)

    def _h_assign(self, h, path, q, body):
        """AssignVolume rpc analog (pb/filer.proto): mount and other write-
        through clients get fids + upload urls without talking to the
        master themselves."""
        count = self._qint(q, "count", 1)
        try:
            if count <= 1:
                # single-fid asks ride the lease/coalescer with the write path
                a = self._assign_one(
                    q.get("collection", self.collection),
                    q.get("replication", self.replication),
                    q.get("ttl", ""),
                )
            else:
                a = operation.assign(
                    self.master_url,
                    count=count,
                    collection=q.get("collection", self.collection),
                    replication=q.get("replication", self.replication),
                    ttl=q.get("ttl", ""),
                )
        except Exception as e:
            return 500, {"error": str(e)}
        return 200, {
            "fid": a.fid,
            "url": a.url,
            "publicUrl": a.public_url,
            "count": a.count,
            "auth": a.auth,
        }

    def _meta_reply(self, log, q):
        since = self._qint(q, "since_ns", 0)
        limit = self._qint(q, "limit", 1000)
        # tolerant_ufloat clamps garbage, negatives AND NaN to 0 (a NaN
        # deadline busy-loops Condition.wait)
        wait_s = min(tolerant_ufloat(q.get("wait_s", 0), 0.0), 30.0)
        events = log.wait_since(since, timeout=wait_s)[:limit]
        out = [e.to_dict() for e in events]
        last = out[-1]["ts_ns"] if out else since
        return 200, {
            "events": out,
            "last_ts_ns": last,
            # since_ns below this means history was pruned → client must
            # resync from a snapshot (round-1 rings lost this signal)
            "oldest_ts_ns": log.oldest_ts_ns(),
        }

    def _h_meta_events(self, h, path, q, body):
        """SubscribeLocalMetadata analog: this filer's own mutations, replayed
        from the persisted log then tailed, with optional long-poll
        (server/filer_grpc_server_sub_meta.go:61)."""
        return self._meta_reply(self.filer.meta_log, q)

    def _h_meta_watch(self, h, path, q, body):
        """SubscribeMetadata analog: the cluster-wide aggregated feed — own
        mutations plus every peer's, merged by the MetaAggregator
        (server/filer_grpc_server_sub_meta.go:17)."""
        return self._meta_reply(self.meta_aggregator.feed, q)

    def _h_kv(self, h, path, q, body):
        key = path[len("/_kv/") :].encode()
        if h.command == "PUT" or h.command == "POST":
            self.filer.store.kv_put(key, body)
            return 200, {"ok": True}
        if h.command == "DELETE":  # KvDelete rpc (filer.proto)
            self.filer.store.kv_delete(key)
            return 200, {"ok": True}
        v = self.filer.store.kv_get(key)
        if v is None:
            return 404, {"error": "not found"}
        return 200, v

    def _h_ui(self, h, path, q, body):
        """Embedded status page (server/filer_ui analog)."""
        from .status_ui import render_status_page

        _, status = self._h_status(h, path, q, body)
        h.extra_headers = {"Content-Type": "text/html; charset=utf-8"}
        return 200, render_status_page(
            f"seaweedfs_tpu filer {self.url}", {"Filer": status}
        )

    @staticmethod
    def _sync_stats_safe() -> dict:
        from ..replication.controller import sync_stats

        return sync_stats()

    def _h_ring(self, h, path, q, body):
        """Shard layout + the tail/scale counters an operator reads when
        debugging the fleet: ring placement, hedge outcomes, fid-lease
        minting, deadline aborts."""
        return 200, {
            "ring": self.ring.plan(),
            "hedge": _hedge.STATS.snapshot(),
            "fid_leases": self._fid_leases.stats(),
            "deadline": _deadline.counts(),
        }

    def _h_reshard(self, h, path, q, body):
        """Drive a subtree handoff FROM this filer to ``target``: the
        marker-guarded, checkpointed copy in filer/reshard.py. Idempotent
        — kill this daemon mid-run and a re-POST with the same epoch
        resumes from the durable prefix and converges."""
        from ..filer.reshard import Resharder

        root = q.get("root", "")
        target = q.get("target", "")
        if not root or not target:
            return 400, {"error": "root and target are required"}
        try:
            summary = Resharder(
                self.url, target, root, q.get("epoch", "0"),
                ckpt_every=self._qint(q, "ckpt_every", 32),
            ).run()
        except Exception as e:  # reshard is re-POSTable; the error is the operator's signal
            return 500, {"error": str(e)}
        return 200, summary

    def _h_status(self, h, path, q, body):
        return 200, {
            "signature": self.signature,
            "url": self.url,
            "master": self.master_url,
            # GetFilerConfiguration analog: mount/sync clients must know to
            # encrypt their chunks when the filer runs -encryptVolumeData
            "cipher": self.cipher,
            # mem- AND disk-tier hit/miss counters (TieredChunkCache.stats)
            "chunk_cache": self.chunk_cache.stats(),
            "pipeline": {
                "read_window": self.read_window,
                "write_window": self.write_window,
            },
            # OrderedLock sanitizer counters + observed order edges
            # (all-zero unless the process runs with SWEED_LOCK_CHECK=1)
            "locks": lock_stats(),
            # scan-engine counters (process-wide: rows/bytes through every
            # /_query and /_select plan of this process)
            "query": self._query_stats(),
            # this filer's own /_query routing: single-chunk requests the
            # volume servers answered, and scans run here
            "query_routes": self.query_routes(),
            # serving-core counters: mode, inflight connections,
            # admission shedding, loop lag
            "serving": SERVING.snapshot(),
            # cross-cluster replication: per-direction lag/inflight/dlq
            # (network-free snapshot — readable while the peer is down)
            "sync": self._sync_stats_safe(),
            # request-latency quantiles straight from the cumulative-bucket
            # histograms that also feed /metrics (no parallel bookkeeping)
            "request_latency": {
                "write": self._req_hist.summary(op="write"),
                "read": self._req_hist.summary(op="read"),
                "read_stream": self._req_hist.summary(op="read_stream"),
            },
            # metadata fleet: shard layout + hedge/lease/deadline counters
            "ring": self.ring.plan(),
            "hedge": _hedge.STATS.snapshot(),
            "fid_leases": self._fid_leases.stats(),
            "deadline": _deadline.counts(),
            "trace": _trace.trace_stats(),
        }

    def _h_metrics(self, h, path, q, body):
        return 200, self.metrics.expose().encode()

    def _h_query(self, h, path, q, body):
        """S3-Select-ish scan of a stored CSV/JSON file.

        Data locality first: a single-chunk plain entry is queried ON the
        volume server holding its needle (POST /_query {fid,...} —
        volume_grpc_query.go:12), so the object bytes never cross the
        network. Multi-chunk / cipher'd entries (row boundaries span
        chunks; keys live here) fall back to filer-side execution."""
        req = json.loads(body)
        target = req.get("path", "")
        try:
            entry = self.filer.find_entry(target)
        except NotFoundError:
            return 404, {"error": f"{target} not found"}
        chunks = entry.chunks or []
        if (
            len(chunks) == 1
            and not chunks[0].cipher_key
            and not chunks[0].is_chunk_manifest
        ):
            fid = chunks[0].file_id
            fwd = {k: v for k, v in req.items() if k != "path"}
            fwd["fid"] = fid
            if self.jwt_read_key:
                # volume-side /_query enforces the fid-scoped read gate;
                # mint the token so locality still engages in auth-enabled
                # deployments
                from ..security import gen_jwt

                fwd["auth"] = gen_jwt(self.jwt_read_key, fid)
            try:
                locations = self._lookup.lookup(int(fid.split(",")[0]))
            except Exception as e:  # noqa: BLE001 — locality is best-effort
                glog.V(1).info("data-local query fell back: %s", e)
                locations = []
            # every holder in turn: one that refuses or fails hands the
            # query to the next; the filer scans only when all have failed
            for loc in locations:
                try:
                    r = http_json(
                        "POST", f"http://{loc['url']}/_query", fwd, timeout=30
                    )
                except Exception as e:  # noqa: BLE001 — locality is best-effort
                    glog.V(1).info("data-local query at %s failed: %s", loc["url"], e)
                    continue
                if "rows" in r or r.get("error", "").startswith("bad sql"):
                    status = 400 if "rows" not in r else 200
                    self._count_route("pushdown")
                    return status, r
        from ..query import scan_request

        self._count_route("filer_side")
        return scan_request(self._entry_chunks(entry), req,
                            backend=self.query_backend)

    def _count_route(self, route: str) -> None:
        with self._routes_lock:
            self._routes[route] += 1

    def query_routes(self) -> dict:
        """How this filer's /_query requests ran: ``pushdown`` answered by
        the volume server holding the single chunk, ``filer_side`` scanned
        here (multi-chunk, cipher'd or manifest entries, or a failed
        pushdown)."""
        with self._routes_lock:
            return dict(self._routes)

    def _entry_chunks(self, entry: Entry):
        """An entry's full content as a streaming chunk iterator — the
        prefetching read path (_stream_range rides util/pipeline.
        prefetch_iter), so a multi-chunk object feeds the scan engine's
        device batches without stalling on volume round-trips."""
        size = entry.file_size()
        return self._stream_range(entry, 0, size) if size else iter(())

    def _h_select(self, h, path, q, body):
        """S3 SelectObjectContent execution: the gateway forwards the
        client's raw request XML; the reply body is the framed AWS
        event stream (Records/Progress/Stats/End).  Protocol errors come
        back as JSON with the S3 error code for the gateway to map."""
        target = q.get("path", "")
        try:
            entry = self.filer.find_entry(target)
        except NotFoundError:
            return 404, {"error": f"{target} not found"}
        from ..query import select as s3select

        try:
            req = s3select.parse_select_request(body)
            payload = b"".join(s3select.run_select(
                self._entry_chunks(entry), req, backend=self.query_backend))
        except s3select.SelectError as e:
            return 400, {"error": e.message, "error_code": e.code}
        h.extra_headers = {"Content-Type": "application/octet-stream"}
        return 200, payload

    @staticmethod
    def _sigs(q) -> Optional[list[int]]:
        raw = q.get("sig", "")
        return [int(x) for x in raw.split(",") if x] or None

    # -- write path (auto-chunking) ------------------------------------------
    @JsonHandler.mark_streaming
    def _h_write_stream(self, h, path, q, rfile, length):
        """Streaming front of the write path (filer_server_handlers_write_
        autochunk.go uploadReaderToChunks): file bodies are consumed from
        the socket one chunk at a time — peak memory is one chunk + its
        ciphertext regardless of file size. Metadata-shaped requests
        (rename/link/meta/mkdir) buffer their small bodies and take the
        plain path."""
        parsed_path = urllib.parse.unquote(path)
        targets = [parsed_path, q.get("mv.to", ""), q.get("link.to", "")]
        if any(has_dot_segments(t) for t in targets if t):
            # the filer stores path segments literally (no resolution, so
            # no traversal), but a literal "." / ".." entry is
            # unrepresentable through the FUSE mount and poisons POSIX
            # listings on every gateway above — refuse at the chokepoint
            # they all share. The unconsumed body is drained bounded and
            # timeout-guarded (a stalling client must not pin the worker).
            from .http_util import CountedReader, drain_refused_body

            drain_refused_body(h, CountedReader(rfile, length))
            return 400, {"error": "dot path segments not allowed"}
        g = self._ring_write_gate(h, path, q, rfile, length)
        if g is not None:
            return g
        meta_shaped = (
            q.get("mv.to") or q.get("link.to") or q.get("meta") == "true"
            or parsed_path.endswith("/")
        )
        with self._req_hist.time(op="write"):
            if meta_shaped:
                body = rfile.read(length) if length else b""
                return self._h_write_inner(h, path, q, body)
            return self._h_write_file(h, parsed_path, q, rfile, length)

    def _read_exact(self, rfile, want: int) -> bytes:
        out = bytearray()
        while len(out) < want:
            got = rfile.read(want - len(out))
            if not got:
                raise IOError(
                    f"client disconnected {want - len(out)} bytes early"
                )
            out += got
        return bytes(out)

    def _h_write_file(self, h, path, q, rfile, length):
        # path-prefix storage rules (filer_conf.go): explicit query params
        # win, then the longest-prefix rule, then server defaults
        rule = self.filer_conf.match_storage_rule(path)
        collection = q.get("collection") or rule.collection or self.collection
        replication = q.get("replication") or rule.replication or self.replication
        ttl = q.get("ttl") or rule.ttl or ""
        use_cipher = self.cipher or q.get("cipher") == "true"
        chunks: list[FileChunk] = []
        uploaded_fids: list[str] = []  # every fid ASSIGNED, incl. manifest blobs
        md5 = hashlib.md5()
        offset = 0
        window = self.write_window
        pipe = None
        try:
            if window > 1 and length > self.chunk_size:
                # overlapped autochunk (uploadReaderToChunks): the socket
                # read of piece k+1 proceeds while pieces k, k-1, … are in
                # assign+encrypt+upload flight; submit blocks once `window`
                # uploads are pending, so resident data stays bounded at
                # window × chunk_size
                from ..util.pipeline import BoundedExecutor

                n_pieces = -(-length // self.chunk_size)
                assigner = _FidBatch(
                    self, collection, replication, ttl,
                    batch=min(n_pieces, max(2, window)),
                    lanes=min(n_pieces, window),
                ).next
                pipe = BoundedExecutor(window, name="filer-write")
                while offset < length:
                    piece = self._read_exact(
                        rfile, min(self.chunk_size, length - offset)
                    )
                    md5.update(piece)
                    pipe.submit(
                        self._upload_piece, piece, offset, collection,
                        replication, ttl, use_cipher,
                        assigner=assigner, record=uploaded_fids.append,
                    )
                    offset += len(piece)
                chunks = pipe.drain()  # submit order == offset order
            else:
                while offset < length:
                    piece = self._read_exact(
                        rfile, min(self.chunk_size, length - offset)
                    )
                    md5.update(piece)
                    chunks.append(self._upload_piece(
                        piece, offset, collection, replication, ttl,
                        use_cipher, record=uploaded_fids.append,
                    ))
                    offset += len(piece)
            if len(chunks) >= self.manifest_batch:
                from ..filer.filechunk_manifest import maybe_manifestize

                def _save(blob):
                    c = self._save_blob_as_chunk(
                        blob, collection, replication, ttl, use_cipher
                    )
                    uploaded_fids.append(c.file_id)
                    return c

                chunks = maybe_manifestize(_save, chunks, self.manifest_batch)
            # header names arrive case-mangled (urllib capitalizes);
            # Title-Case them so readers filter with a canonical prefix
            extended = {
                k[len("Seaweed-") :].title(): v
                for k, v in h.headers.items()
                if k.title().startswith("Seaweed-")
            }
            extended["md5"] = md5.hexdigest()
            entry = Entry(
                full_path=path,
                mime=h.headers.get("Content-Type", "") or "",
                collection=collection,
                replication=replication,
                chunks=chunks,
                extended=extended,
            )
            self.filer.create_entry(entry, signatures=self._sigs(q))
        except Exception:
            # nothing was committed (create_entry is the commit point):
            # don't leak ANY stored chunk — data or manifest blob. The
            # in-flight window is settled FIRST so the purge sees the
            # complete set of assigned fids (a worker mid-upload when the
            # socket read failed must not add a fid after the purge ran).
            if pipe is not None:
                pipe.abort()
            if uploaded_fids:
                self._purge_chunks(uploaded_fids)
            raise
        self._maybe_reload_conf(path)
        return 201, {
            "name": entry.name,
            "size": length,
            "chunks": len(chunks),
            "eTag": extended["md5"],
        }

    def _upload_piece(self, piece: bytes, offset: int, collection: str,
                      replication: str, ttl: str, use_cipher: bool,
                      assigner=None, record=None) -> FileChunk:
        a = (
            assigner()
            if assigner is not None
            else self._assign_one(collection, replication, ttl)
        )
        if record is not None:
            # record BEFORE uploading: a piece that fails (or crashes) mid-
            # upload must still have its fid purged by the caller — deleting
            # a never-written needle is a no-op, leaking a written one isn't
            record(a.fid)
        faultpoints.fire("filer.write.piece")
        cipher_key_b64 = ""
        payload = piece
        if use_cipher:
            # fresh key per chunk; the store holds only ciphertext and the
            # filer entry holds the key (_write_cipher.go)
            from ..util import cipher as cipher_mod

            key = cipher_mod.gen_cipher_key()
            payload = cipher_mod.encrypt(piece, key)
            cipher_key_b64 = base64.b64encode(key).decode()
        r = operation.upload_data(a.url, a.fid, payload, ttl=ttl, jwt=a.auth)
        return FileChunk(
            file_id=a.fid,
            offset=offset,
            size=len(piece),  # logical (plaintext) size
            mtime=time.time_ns(),
            etag=r.get("eTag", ""),
            cipher_key=cipher_key_b64,
        )

    def _h_write_inner(self, h, path, q, body):
        path = urllib.parse.unquote(path)
        if q.get("mv.to"):
            entry = self.filer.rename(path.rstrip("/") or "/", q["mv.to"])
            self._maybe_reload_conf(path.rstrip("/"), q["mv.to"])
            return 200, {"name": entry.name, "path": entry.full_path}
        if q.get("link.to"):
            # hardlink: this path becomes another name for link.to's inode
            entry = self.filer.link(q["link.to"], path.rstrip("/"))
            return 201, {"name": entry.name, "hard_link_id": entry.hard_link_id}
        if q.get("meta") == "true":
            d = json.loads(body)
            d["full_path"] = path.rstrip("/") or "/"
            entry = self.filer.create_entry(
                Entry.from_dict(d), signatures=self._sigs(q)
            )
            self._maybe_reload_conf(entry.full_path)
            return 201, {"name": entry.name}
        if path.endswith("/"):
            if q.get("mkdir") == "true":
                entry = Entry(
                    full_path=path.rstrip("/") or "/", is_directory=True, mode=0o775
                )
                self.filer.create_entry(entry, signatures=self._sigs(q))
                return 201, {"name": entry.name}
            return 400, {"error": "cannot write to a directory path"}
        # every meta_shaped condition returned above; file bodies go through
        # _h_write_file via the streaming dispatch, never through here
        raise AssertionError("non-meta body reached _h_write_inner")

    # -- read path ------------------------------------------------------------
    def _h_read(self, h, path, q, body):
        g = self._ring_read_gate(h, path, q)
        if g is not None:
            return g
        with self._req_hist.time(op="read"):
            return self._h_read_inner(h, path, q, body)

    def _h_read_inner(self, h, path, q, body):
        path = urllib.parse.unquote(path)
        lookup = path.rstrip("/") or "/"
        try:
            entry = self.filer.find_entry(lookup)
        except NotFoundError:
            return 404, {"error": f"{path} not found"}
        # meta=true returns the raw entry (works for dirs too, unless the
        # trailing slash asks for a listing) — LookupDirectoryEntry analog
        if q.get("meta") == "true" and not (
            entry.is_directory and path.endswith("/")
        ):
            return 200, entry.to_dict()
        if entry.is_directory:
            limit = self._qint(q, "limit", 1000)
            prefix = q.get("prefix", "")
            full_meta = q.get("meta") == "true"
            entries = []
            # page through the store so a name-prefix filter can't starve the
            # result when non-matching names fill the first page
            cursor = q.get("lastFileName", "")
            while len(entries) < limit:
                page = list(self.filer.list_entries(lookup, cursor, limit))
                if not page:
                    break
                for e in page:
                    cursor = e.name
                    if prefix and not e.name.startswith(prefix):
                        continue
                    entries.append(
                        e.to_dict() | {"name": e.name}
                        if full_meta
                        else {
                            "name": e.name,
                            "is_directory": e.is_directory,
                            "size": e.file_size(),
                            "mtime": e.mtime,
                            "mime": e.mime,
                        }
                    )
                    if len(entries) >= limit:
                        break
                if len(page) < limit:
                    break
            return 200, {"path": lookup, "entries": entries, "lastFileName": cursor}
        from .http_util import (
            parse_byte_range,
            range_headers,
            unsatisfiable_range_headers,
        )

        total = entry.file_size()
        offset, size = 0, total
        rng = h.headers.get("Range", "")
        parsed = parse_byte_range(rng, total) if rng else None
        if parsed == "unsatisfiable":
            h.extra_headers = unsatisfiable_range_headers(total)
            return 416, {"error": f"range {rng!r} beyond size {total}"}
        if parsed is not None:
            start, end = parsed
            offset, size = start, end - start + 1
        # stream chunk views instead of assembling the body (filer
        # stream.go StreamContent): the daemon holds one chunk at a time
        # no matter how large the object is
        from .http_util import StreamBody

        body = StreamBody(size, self._stream_range(entry, offset, size))
        if parsed is not None:
            h.extra_headers = range_headers(offset, offset + size - 1, total)
            return 206, body
        return 200, body

    def _save_blob_as_chunk(
        self,
        blob: bytes,
        collection: str,
        replication: str,
        ttl: str,
        use_cipher: bool,
    ) -> FileChunk:
        """Assign + upload one blob; used for manifest chunks."""
        a = self._assign_one(collection, replication, ttl)
        cipher_key_b64 = ""
        payload = blob
        if use_cipher:
            from ..util import cipher as cipher_mod

            key = cipher_mod.gen_cipher_key()
            payload = cipher_mod.encrypt(blob, key)
            cipher_key_b64 = base64.b64encode(key).decode()
        operation.upload_data(a.url, a.fid, payload, ttl=ttl, jwt=a.auth)
        return FileChunk(
            file_id=a.fid,
            offset=0,
            size=len(blob),
            mtime=time.time_ns(),
            cipher_key=cipher_key_b64,
        )

    def _chunk_range(self, view) -> Optional[tuple[int, int]]:
        """The ``(offset, size)`` to fetch of a chunk view's chunk, or None
        to fetch the whole chunk and cache it. A view takes only its bytes
        when it is not the whole chunk, the chunk is not cipher'd (AES-GCM
        authenticates the whole blob) and the cache would not keep the
        chunk: above the memory tier's limit, with no disk tier that takes
        it (filer/reader_at.go asks for the range whenever a view is not
        the whole chunk)."""
        if view.is_full_chunk or view.cipher_key:
            return None
        cache = self.chunk_cache
        if view.chunk_size <= cache.mem_limit:
            return None
        if cache.disk is not None and view.chunk_size <= cache.disk_limit:
            return None
        return view.offset, view.size

    @staticmethod
    def _fetch_key(view, byte_range):
        """The read-ahead's single-flight key: the chunk, or the piece."""
        if byte_range is None:
            return view.file_id
        return view.file_id, byte_range[0], byte_range[1]

    def _fetch_chunk(self, file_id: str,
                     byte_range: Optional[tuple[int, int]] = None) -> bytes:
        """One stored chunk's raw (possibly encrypted) bytes, cache-aside;
        with ``byte_range`` ``(offset, size)`` only those bytes, asked for
        by ``Range`` from every holder tried and never cached.

        Tail-at-scale: with a second replica available, a hedge leg fires
        against it after a delay derived from this histogram's own live
        p99 (util/hedge.py) — only the slowest ~1% of fetches race two
        copies, the budget gate bounds the extra backend load, and a
        FAILED primary fails over immediately regardless of budget."""
        from ..storage.file_id import FileId
        from .http_util import http_bytes

        if byte_range is None:
            data = self.chunk_cache.get(file_id)
            if data is not None:
                return data
        fid = FileId.parse(file_id)
        locs = self._lookup.lookup(fid.volume_id)
        from ..security import read_auth_query

        auth = read_auth_query(self.jwt_read_key, file_id)
        headers = operation.range_header(byte_range)

        def leg(url):
            def call():
                status, body = http_bytes(
                    "GET", f"http://{url}/{file_id}{auth}", headers=headers
                )
                got = operation.reply_bytes(status, body, byte_range)
                if got is None:
                    raise ConnectionError(
                        f"chunk {file_id}@{url}: HTTP {status}"
                    )
                return got
            return call

        if locs:
            hedge_leg = leg(locs[1]["url"]) if len(locs) > 1 else None
            delay = _hedge.pick_delay_s(self._chunk_hist.quantile(0.99))
            try:
                with self._chunk_hist.time():
                    data, winner = _hedge.hedged_call(
                        leg(locs[0]["url"]), hedge_leg, delay
                    )
                if winner == "hedge":
                    _tag_hedge_won()
            except Exception:  # remaining replicas + master re-lookup still serve
                data = None
            if data is None:
                for loc in locs[2:]:
                    try:
                        status, body = http_bytes(
                            "GET", f"http://{loc['url']}/{file_id}{auth}",
                            headers=headers,
                        )
                    except OSError:
                        continue
                    data = operation.reply_bytes(status, body, byte_range)
                    if data is not None:
                        break
        if data is None:
            self._lookup.invalidate(fid.volume_id)
            data = operation.download(
                self.master_url, file_id, jwt_read_key=self.jwt_read_key,
                byte_range=byte_range,
            )
        if byte_range is None:
            # the cache (incl. its on-disk tiers) holds ciphertext only
            self.chunk_cache.put(file_id, data)
        return data

    def _read_chunk_plain(self, file_id: str, cipher_key: str) -> bytes:
        data = self._fetch_chunk(file_id)
        if cipher_key:
            from ..util import cipher as cipher_mod

            data = cipher_mod.decrypt(data, base64.b64decode(cipher_key))
        return data

    def _resolve_chunks(self, chunks) -> list[FileChunk]:
        """Expand chunk manifests (filechunk_manifest.go ResolveChunkManifest)."""
        from ..filer.filechunk_manifest import (
            has_chunk_manifest,
            resolve_chunk_manifest,
        )

        if not has_chunk_manifest(chunks):
            return list(chunks)
        return resolve_chunk_manifest(self._read_chunk_plain, chunks)

    _ZERO_PIECE = 1 << 20  # sparse gaps stream as bounded zero blocks

    def _stream_range(self, entry: Entry, offset: int, size: int):
        """Generator of body pieces for [offset, offset+size): chunk views
        are fetched (cache-aside, or only their bytes where
        ``_chunk_range`` says so) with an N-deep read-ahead — up to
        ``read_window`` upcoming chunk fids in concurrent flight while the
        current piece streams (reader_cache.go MaybeCache) — and yielded
        strictly in view order, decrypting per chunk; implicit gaps between
        views stream as zeros in bounded pieces, matching the buffered
        assembly in _read_range byte for byte regardless of the window. A
        two-slot plaintext memo keeps interleaved views over two fids from
        re-decrypting per transition while bounding memory. The FIRST piece
        is produced eagerly, so a failure fetching the first chunk (volume
        down) still surfaces as a 500 — only mid-body failures degrade to a
        short 200 body (the connection is dropped so the client sees
        truncation, http_util._reply_stream)."""
        views = view_from_chunks(self._resolve_chunks(entry.chunks), offset, size)
        end = offset + size

        def produce():
            from collections import OrderedDict

            from ..util.pipeline import prefetch_iter

            window = self.read_window
            if len({v.file_id for v in views}) <= 1:
                window = 1  # nothing ahead to prefetch; skip the pool
            pos = offset
            memo: OrderedDict[str, bytes] = OrderedDict()
            ranges = {v: self._chunk_range(v) for v in views}
            fetched = prefetch_iter(
                views,
                lambda v: self._fetch_chunk(v.file_id, ranges[v]),
                window,
                # single-flight per fid, or per piece of a ranged view
                key=lambda v: self._fetch_key(v, ranges[v]),
            )
            try:
                for view, raw in fetched:
                    if view.logic_offset > pos:  # sparse gap
                        gap = view.logic_offset - pos
                        while gap > 0:
                            n = min(self._ZERO_PIECE, gap)
                            yield b"\x00" * n
                            gap -= n
                            pos += n
                    if ranges[view] is not None:
                        piece = raw  # the view's own bytes, plaintext
                    else:
                        data = memo.get(view.file_id)
                        if data is None:
                            data = raw
                            if view.cipher_key:
                                from ..util import cipher as cipher_mod

                                data = cipher_mod.decrypt(
                                    data, base64.b64decode(view.cipher_key)
                                )
                            memo[view.file_id] = data
                            while len(memo) > 2:
                                memo.popitem(last=False)
                        piece = data[view.offset : view.offset + view.size]
                    if piece:
                        yield piece
                        pos += len(piece)
            finally:
                # client gone mid-stream: shut the prefetcher down without
                # waiting so the handler thread is never wedged on unread
                # read-ahead
                fetched.close()
            tail = end - pos
            while tail > 0:
                n = min(self._ZERO_PIECE, tail)
                yield b"\x00" * n
                tail -= n

        gen = produce()
        try:
            first = next(gen)
        except StopIteration:
            return iter(())

        def timed():
            # the handler's histogram context closes before streaming; time
            # the actual data-plane work here so read latency stays honest
            t0 = time.perf_counter()
            try:
                yield first
                yield from gen
            finally:
                self._req_hist.observe(
                    time.perf_counter() - t0, op="read_stream"
                )

        return timed()

    async def _afetch_chunk(self, file_id: str, url: str,
                            hedge_url: Optional[str] = None,
                            byte_range: Optional[tuple[int, int]] = None) -> bytes:
        """Async mirror of _fetch_chunk for the native read path: volume
        urls resolved by the caller from the cached vid map, the loop's
        pooled keep-alive transport, cache-aside ciphertext, or with
        ``byte_range`` only those bytes, uncached. With a second replica
        url the same p99-triggered hedge race runs here — natively, so the
        losing task gets a real cancel()."""
        if byte_range is None:
            data = self.chunk_cache.get(file_id)
            if data is not None:
                return data
        from ..security import read_auth_query
        from . import aio_transport

        auth = read_auth_query(self.jwt_read_key, file_id)
        headers = operation.range_header(byte_range)

        async def leg(u: str) -> bytes:
            status, body, _ = await aio_transport.request(
                "GET", f"http://{u}/{file_id}{auth}", headers=headers
            )
            got = operation.reply_bytes(status, body, byte_range)
            if got is None:
                raise ConnectionError(f"chunk {file_id}@{u}: HTTP {status}")
            return got

        t0 = time.perf_counter()
        try:
            if hedge_url is None:
                body = await leg(url)
            else:
                delay = _hedge.pick_delay_s(
                    self._chunk_hist.quantile(0.99)
                )
                body, winner = await _hedge.ahedged_call(
                    lambda: leg(url), lambda: leg(hedge_url), delay
                )
                if winner == "hedge":
                    _tag_hedge_won()
        finally:
            self._chunk_hist.observe(time.perf_counter() - t0)
        if byte_range is None:
            self.chunk_cache.put(file_id, body)
        return body

    async def _astream_range(self, views, urls: dict, offset: int,
                             size: int, alts: Optional[dict] = None,
                             first: Optional[bytes] = None):
        """Async generator of body pieces for [offset, offset+size) —
        the native mirror of _stream_range's produce(): aprefetch_iter
        drives up to ``read_window`` chunk fetches concurrently ON the
        loop, pieces yield strictly in view order, sparse gaps stream as
        bounded zero blocks, and a two-slot plaintext memo bounds
        re-decryption. ``first`` is the first view's fetch, when the
        caller has it. Byte-for-byte identical to the bridged stream."""
        from collections import OrderedDict

        from ..util.aio_pipeline import aprefetch_iter

        end = offset + size
        window = self.read_window
        if len({v.file_id for v in views}) <= 1:
            window = 1
        pos = offset
        memo: OrderedDict[str, bytes] = OrderedDict()
        t0 = time.perf_counter()
        hedge_urls = alts or {}
        ranges = {v: self._chunk_range(v) for v in views}

        async def fetch(v):
            nonlocal first
            if first is not None and v is views[0]:
                raw, first = first, None
                return raw
            return await self._afetch_chunk(
                v.file_id, urls[v.file_id], hedge_urls.get(v.file_id),
                ranges[v],
            )

        fetched = aprefetch_iter(
            views,
            fetch,
            window,
            # single-flight per fid, or per piece of a ranged view
            key=lambda v: self._fetch_key(v, ranges[v]),
        )
        try:
            async for view, raw in fetched:
                if view.logic_offset > pos:  # sparse gap
                    gap = view.logic_offset - pos
                    while gap > 0:
                        n = min(self._ZERO_PIECE, gap)
                        yield b"\x00" * n
                        gap -= n
                        pos += n
                if ranges[view] is not None:
                    piece = raw  # the view's own bytes, plaintext
                else:
                    data = memo.get(view.file_id)
                    if data is None:
                        data = raw
                        if view.cipher_key:
                            from ..util import cipher as cipher_mod

                            data = cipher_mod.decrypt(
                                data, base64.b64decode(view.cipher_key)
                            )
                        memo[view.file_id] = data
                        while len(memo) > 2:
                            memo.popitem(last=False)
                    piece = data[view.offset : view.offset + view.size]
                if piece:
                    yield piece
                    pos += len(piece)
            tail = end - pos
            while tail > 0:
                n = min(self._ZERO_PIECE, tail)
                yield b"\x00" * n
                tail -= n
        finally:
            # close-without-wait on client-gone lives inside
            # aprefetch_iter's finally; here only the latency record
            self._req_hist.observe(
                time.perf_counter() - t0, op="read_stream"
            )

    async def _h_read_native(self, h, path, q):
        """Native-async filer GET: find_entry is a local metadata read,
        the filer→volume hop rides the asyncio pooled transport, and
        chunk read-ahead runs natively on the loop. Edges fall back to
        the bridged _h_read for canonical bytes: meta=true, directories,
        chunk manifests (resolution does sync chunk reads), 404/416
        rendering, and volume locations not yet in the cached vid map
        (the bridged path does the master round-trip that populates it).
        """
        from .http_util import (
            NATIVE_FALLBACK,
            AsyncStreamBody,
            parse_byte_range,
            range_headers,
        )

        if q.get("meta") == "true":
            return NATIVE_FALLBACK
        t0 = time.perf_counter()
        lookup = urllib.parse.unquote(path).rstrip("/") or "/"
        if (
            self.ring.active
            and q.get("noRedirect") != "1"
            and not self.ring.owns(lookup)
        ):
            return NATIVE_FALLBACK  # bridged ring gate renders the 307
        try:
            entry = self.filer.find_entry(lookup)
        except NotFoundError:
            # bridge renders the canonical 404 — or, for a spine-depth
            # file whose owner is a peer, the ring gate's redirect
            return NATIVE_FALLBACK
        if entry.is_directory:
            return NATIVE_FALLBACK
        from ..filer.filechunk_manifest import has_chunk_manifest

        chunks = list(entry.chunks)
        if has_chunk_manifest(chunks):
            return NATIVE_FALLBACK
        total = entry.file_size()
        offset, size = 0, total
        rng = h.headers.get("Range", "")
        parsed = parse_byte_range(rng, total) if rng else None
        if parsed == "unsatisfiable":
            return NATIVE_FALLBACK  # canonical 416 body stays bridged
        if parsed is not None:
            start, end = parsed
            offset, size = start, end - start + 1
        views = view_from_chunks(chunks, offset, size)
        # every chunk's volume must already be in the pushed vid map —
        # a miss would cost a sync master round-trip on the loop
        from ..storage.file_id import FileId

        vid_map = self._master_client.vid_map
        urls: dict[str, str] = {}
        alts: dict[str, str] = {}  # second replica per fid → hedge leg
        for v in views:
            if v.file_id in urls:
                continue
            locs = vid_map.lookup_volume(
                FileId.parse(v.file_id).volume_id
            )
            if not locs:
                return NATIVE_FALLBACK
            urls[v.file_id] = locs[0].url
            if len(locs) > 1:
                alts[v.file_id] = locs[1].url
        first = None
        if views:
            # eager first chunk, like _stream_range's eager first piece:
            # a down volume surfaces as a bridged 500, not a truncated
            # native 200; the stream starts from what it fetched
            try:
                first = await self._afetch_chunk(
                    views[0].file_id, urls[views[0].file_id],
                    alts.get(views[0].file_id), self._chunk_range(views[0]),
                )
            except Exception:  # noqa: BLE001 — bridge retries all replicas
                return NATIVE_FALLBACK
        body = AsyncStreamBody(
            size, self._astream_range(views, urls, offset, size, alts, first)
        )
        self._req_hist.observe(time.perf_counter() - t0, op="read")
        if parsed is not None:
            h.extra_headers = range_headers(offset, offset + size - 1, total)
            return 206, body
        return 200, body

    def _read_range(self, entry: Entry, offset: int, size: int) -> bytes:
        """StreamContent (filer/stream.go:16): chunk views → volume reads.

        A view takes only its bytes where ``_chunk_range`` says so, else
        its whole chunk is fetched (cache-aside) and sliced; volume lookups
        are cached to keep master round-trips off the read path."""
        # clamp to the entry's real extent: offset/size trace back to
        # request ranges, and the allocation below must never exceed what
        # the entry can actually hold
        total = entry.file_size()
        offset = max(0, min(offset, total))
        size = max(0, min(size, total - offset))
        views = view_from_chunks(self._resolve_chunks(entry.chunks), offset, size)
        out = bytearray(size)
        decrypted: dict[str, bytes] = {}  # per-call memo; cache stays ciphertext
        for view in views:
            byte_range = self._chunk_range(view)
            if byte_range is not None:
                piece = self._fetch_chunk(view.file_id, byte_range)
            else:
                data = decrypted.get(view.file_id)
                if data is None:
                    data = self._fetch_chunk(view.file_id)
                    if view.cipher_key:
                        from ..util import cipher as cipher_mod

                        data = cipher_mod.decrypt(
                            data, base64.b64decode(view.cipher_key)
                        )
                        decrypted[view.file_id] = data
                piece = data[view.offset : view.offset + view.size]
            pos = view.logic_offset - offset
            out[pos : pos + len(piece)] = piece
        return bytes(out)

    def _h_head(self, h, path, q, body):
        g = self._ring_point_gate(h, path, q)
        if g is not None:
            return g
        path = urllib.parse.unquote(path).rstrip("/") or "/"
        try:
            entry = self.filer.find_entry(path)
        except NotFoundError:
            return 404, b""
        return 200, json.dumps({"size": entry.file_size()}).encode()

    # -- delete ----------------------------------------------------------------
    def _h_delete(self, h, path, q, body):
        g = self._ring_delete_gate(h, path, q)
        if g is not None:
            return g
        return self._h_delete_inner(h, path, q, body)

    def _h_delete_inner(self, h, path, q, body):
        path = urllib.parse.unquote(path).rstrip("/") or "/"
        try:
            fids = self.filer.delete_entry(
                path,
                recursive=q.get("recursive") == "true",
                ignore_recursive_error=q.get("ignoreRecursiveError") == "true",
                skip_chunk_purge=q.get("skipChunkPurge") == "true",
                signatures=self._sigs(q),
            )
        except NotFoundError:
            return 404, {"error": f"{path} not found"}
        except OSError as e:
            return 409, {"error": str(e)}
        self._maybe_reload_conf(path)
        # 200 with body, not 204: a 204 must not carry one (keep-alive framing)
        return 200, {"purged_chunks": len(fids)}

    # -- lifecycle -------------------------------------------------------------
    def start(self):
        fs = self

        class Handler(JsonHandler):
            trace_service = "filer"
            routes = [
                ("GET", "/_debug/traces", _trace.h_debug_traces),
                ("GET", "/_assign", fs._h_assign),
                ("GET", "/_meta/events", fs._h_meta_events),
                ("GET", "/_meta/watch", fs._h_meta_watch),
                # _-prefixed like the other filer-internal routes: a bare
                # /ui would shadow user files stored under that prefix
                ("GET", "/_ui", fs._h_ui),
                ("GET", "/_ring", fs._h_ring),
                ("POST", "/_reshard", fs._h_reshard),
                ("GET", "/_status", fs._h_status),
                ("GET", "/metrics", fs._h_metrics),
                ("POST", "/_query", fs._h_query),
                ("POST", "/_select", fs._h_select),
                ("GET", "/_kv/", fs._h_kv),
                ("PUT", "/_kv/", fs._h_kv),
                ("POST", "/_kv/", fs._h_kv),
                ("DELETE", "/_kv/", fs._h_kv),
                ("GET", "/", fs._h_read),
                ("HEAD", "/", fs._h_head),
                ("POST", "/", fs._h_write_stream),
                ("PUT", "/", fs._h_write_stream),
                ("DELETE", "/", fs._h_delete),
            ]
            # hot file reads served natively on the loop; every edge
            # falls back to the bridged _h_read above for canonical bytes
            native_routes = [
                ("GET", "/", fs._h_read_native),
            ]

        self._srv = start_server(Handler, self.host, self.port)
        glog.info("filer up on %s:%d → master %s", self.host, self.port,
                  self.master_url)
        self.meta_aggregator.start()
        return self

    def stop(self):
        self.meta_aggregator.stop()
        self._master_client.stop()
        if self._srv:
            self._srv.shutdown()
            self._srv.server_close()
        self.filer.meta_log.close()
        self.filer.store.close()

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"
