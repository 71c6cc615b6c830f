"""Volume server daemon: needle data plane, admin surface and heartbeats.

Endpoint map (reference -> here), the same wire surface as the JAX
package's volume server, so its master and shell drive this one:

    GET/HEAD /<vid>,<fid>      volume_server_handlers_read.go:28 (plain and
                               EC needles, Range, gzip passthrough, chunk
                               manifests resolved server-side)
    POST/PUT /<vid>,<fid>      volume_server_handlers_write.go:19 (raw body;
                               name/mime via X-Sweed-Name/X-Sweed-Mime)
    DELETE   /<vid>,<fid>      volume_server_handlers_write.go:78
    replicated writes          topology/store_replicate.go:21: the primary
                               fans out `?type=replicate` to the replicas
    BatchDelete rpc            POST /_batch_delete
    AllocateVolume rpc         POST /admin/assign_volume
    DeleteVolume rpc           POST /admin/delete_volume
    VolumeMarkReadonly/Writable POST /admin/readonly, /admin/writable
    VolumeMount/Unmount        POST /admin/volume_mount, /admin/volume_unmount
    vacuum (volume_vacuum.go)  GET  /admin/vacuum_check, POST /admin/vacuum
    VolumeCopy rpc             POST /admin/volume_copy (pull .dat/.idx)
    VolumeTailSender           GET  /admin/tail (framed needles, paged)
    backup's status            GET  /admin/volume_status
    VolumeIncrementalCopy      GET  /admin/incremental_copy (raw .dat bytes)
    VolumeTierMoveDatToRemote  POST /admin/tier_upload (the .dat to an S3 tier)
    VolumeTierMoveDatFromRemote POST /admin/tier_download (and back)
    VolumeConfigure            POST /admin/volume_configure_replication
    VolumeServerLeave          POST /admin/server_leave
    VolumeEcShardsGenerate     POST /admin/ec/generate  (the CUDA kernel)
    VolumeEcShardsRebuild      POST /admin/ec/rebuild   (the CUDA kernel)
    VolumeEcShardsCopy         POST /admin/ec/copy (pull from a source url)
    VolumeEcShardRead rpc      GET  /admin/ec/shard_read (binary)
    VolumeEcShardsMount/Unmount POST /admin/ec/mount, /admin/ec/unmount
    VolumeEcShardsDelete       POST /admin/ec/delete_shards
    VolumeEcShardsToVolume     POST /admin/ec/to_volume (the CUDA kernel)
    CopyFile rpc               GET  /admin/file?volume=&ext= (binary)
    volume.fsck's raw material GET  /admin/needle_ids, /admin/needle_info
    Query rpc                  POST /_query  volume_grpc_query.go:12 (an
                               S3-Select scan of one local needle; the
                               predicate tree runs on the store's device)
    hot-needle cache size      POST /admin/ncache (?capacity=<bytes>, 0 off)
    /metrics, /ui              GET  /metrics (Prometheus text), /ui (HTML)
    /status                    GET  /status

The serving stack is the JAX package's default: the native turbo engine
(``storage/turbo.py``, ``csrc/turbo.cpp``) owns the public port and serves
fid GET/HEAD/POST/PUT/DELETE against the .dat/.idx itself, and proxies
every other request to this daemon on a loopback port, which runs on the
asyncio core (``server/aio.py``) with admission control and sendfile
replies. ``SWEED_TURBO=0`` (or an IP whitelist, which stays in Python)
leaves the engine out and the daemon takes the public port;
``SWEED_SERVING=threads`` runs the thread-per-connection core instead of
the reactor. An engine that cannot be built is reported, not hidden:
``/status``'s ``turbo`` says ``{"on": false, "reason": ...}`` and the log
carries the compiler's output. ``SWEED_NCACHE`` (bytes, default 0) sizes
the hot-needle cache.

With ``SWEED_SCRUB=1`` (read at ``start()``) a background thread re-reads
needles and verifies their CRCs, at most ``SWEED_SCRUB_RATE`` needles a
second a volume, and hashes EC shards against the .vif sums; what it finds
rides the heartbeat to the master.

EC work runs through the store's codec: the hand-written CUDA kernel unless
the server was started with ``ec_backend="cpu"``; ``"mesh"`` runs it on
every local card (``ec/sharded.py``). Without a card the first EC request
answers 500 naming the missing device and writes nothing. ``/_query`` runs
its scan plan on the same device, and without a card answers 500 naming it
too.

With ``SWEED_MESH=1`` the server joins a ``torch.distributed`` mesh at
``start()``, before its first heartbeat, and reports the mesh in every beat
(``mesh_info``), so the master's fleet scheduler prefers it.

Nothing here starts at import: ``start()`` binds the port and starts the
heartbeat (and scrub) thread, ``stop()`` ends them.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Optional

from ..ec import encoder
from ..ec.constants import DATA_SHARDS, SMALL_BLOCK_SIZE, TOTAL_SHARDS, shard_ext
from ..ec.decoder import decode_to_volume
from ..ec.ec_volume import NotFoundError as EcNotFoundError
from ..ec.ec_volume import rebuild_ecx_file
from ..ec.gf_matmul import gf_matmul
from ..query import execute_request
from ..security import Guard, gen_jwt, read_auth_query, verify_fid_jwt
from ..stats import trace
from ..stats.heat import heat_stats
from ..stats.metrics import SCRUB_COUNTERS, default_registry, scrub_stats
from ..storage.commit import atomic_write
from ..storage.disk_location import parse_volume_base_name
from ..storage.file_id import FileId, parse_path
from ..storage.needle import (
    FLAG_HAS_LAST_MODIFIED,
    FLAG_HAS_MIME,
    FLAG_HAS_NAME,
    FLAG_HAS_TTL,
    FLAG_IS_CHUNK_MANIFEST,
    FLAG_IS_COMPRESSED,
    VERSION1,
    CrcError,
    Needle,
    get_actual_size,
    needle_body_length,
    parse_needle_header,
)
from ..storage.replica_placement import ReplicaPlacement
from ..storage.store import NoShardHolderError, Store
from ..storage.ttl import read_ttl
from ..storage.types import NEEDLE_HEADER_SIZE
from ..storage.volume import DeletedError, NotFoundError, volume_file_name
from ..util import faultpoints, glog, images
from ..util.deadline import DeadlineExceeded
from ..util.locks import make_lock
from ..util.needle_cache import NeedleCache
from ..util.parsers import tolerant_uint
from .http_util import (
    NATIVE_FALLBACK,
    SERVING,
    BadRequest,
    JsonHandler,
    SendfileBody,
    http_bytes,
    http_json,
    parse_byte_range,
    range_headers,
    sendfile_min_bytes,
    start_server,
    unsatisfiable_range_headers,
)
from .status_ui import render_status_page


# The loopback address the daemon serves the engine's proxied requests on.
# Not 127.0.0.1: its port comes from the OS (bind to port 0), and on
# 127.0.0.1 that could be a port another process picked as free for its own
# server a moment before and has not bound yet. SWEED_TURBO_BACKEND_HOST
# overrides it.
TURBO_BACKEND_HOST = os.environ.get("SWEED_TURBO_BACKEND_HOST", "127.0.0.2")
# the longest a SWEED_MESH rendezvous may hold start(): torch.distributed's
# own default is 30 minutes
MESH_INIT_TIMEOUT_S = 60.0
# how long a /dir/lookup_ec answer serves remote shard reads: upstream's
# shortest refresh tier (store_ec.go cachedLookupEcShardLocations); a holder
# that fails drops the answer at once, so a moved shard is followed sooner
EC_LOOKUP_TTL_S = 11.0


def _q_req_uint(q: dict, key: str) -> int:
    """Required non-negative query int: a missing or malformed value is the
    client's error (400)."""
    raw = q.get(key)
    val = tolerant_uint(raw, None) if raw is not None else None
    if val is None:
        raise BadRequest(f"bad {key}={raw!r}: non-negative integer required")
    return val


def _q_uint(q: dict, key: str, default: int) -> int:
    """Optional non-negative query int: a missing, malformed or negative
    value falls back to the default, as the reference's handlers do."""
    return tolerant_uint(q.get(key, default), default)


def _q_shards(q: dict) -> list[int]:
    return [int(s) for s in q.get("shards", "").split(",") if s != ""]


def _maybe_decompress(data: bytes) -> bytes:
    """gzip-decode when the bytes carry the gzip magic; anything else passes
    through (util/compression.py maybe_decompress)."""
    if data[:2] == b"\x1f\x8b":
        try:
            return gzip.decompress(data)
        except OSError:
            return data
    return data


def _path_fid(path: str) -> str:
    """'/3,01637037d6.jpg' or '/3/01637037d6' -> '3,01637037d6'."""
    p = path.lstrip("/")
    if "." in p.rsplit("/", 1)[-1]:
        p = p[: p.rindex(".")]
    return p.replace("/", ",", 1)


class VolumeServer:
    def __init__(
        self,
        directories: list[str],
        host: str = "127.0.0.1",
        port: int = 8080,
        master_url: str = "127.0.0.1:9333",
        public_url: str = "",
        data_center: str = "DefaultDataCenter",
        rack: str = "DefaultRack",
        max_volume_count: int = 7,
        pulse_seconds: float = 5.0,
        ec_backend: Optional[str] = None,
        needle_map_kind: str = "dense",
        jwt_signing_key: str = "",
        jwt_read_key: str = "",
        whitelist: Optional[list[str]] = None,
    ):
        self._req_hist = default_registry.histogram(
            "volume_server_request_seconds", "volume server request latency")
        self._req_count = default_registry.counter(
            "volume_server_request_total", "volume server requests")
        self.jwt_signing_key = jwt_signing_key
        self.jwt_read_key = jwt_read_key
        self.queries_served = 0  # /_query scans this server ran
        self._query_lock = make_lock("VolumeServer._query_lock")
        self.guard = Guard(whitelist)
        self.host, self.port = host, port
        # comma-separated seed list (weed volume -mserver=a,b,c); the live
        # target follows the announced leader
        self.master_seeds = [m.strip() for m in master_url.split(",") if m.strip()]
        self.master_url = self.master_seeds[0]
        self.data_center, self.rack = data_center, rack
        self.max_volume_count = max_volume_count
        self.pulse_seconds = pulse_seconds
        # ec_backend None -> "cuda": the hand-written kernel, or an error
        # naming the missing device; only "cpu" selects the plain version
        self.store = Store(directories, ip=host, port=port,
                           public_url=public_url or f"{host}:{port}",
                           ec_backend=ec_backend, needle_map_kind=needle_map_kind)
        self.store.remote_shard_reader = self._remote_shard_reader
        # vid -> (monotonic time, shard id -> holder urls): the master's
        # /dir/lookup_ec answers, kept for EC_LOOKUP_TTL_S (upstream
        # cachedLookupEcShardLocations); ec_lookups counts the asks
        self._ec_locations: dict[int, tuple[float, dict[int, list[str]]]] = {}
        self._ec_locations_lock = make_lock("VolumeServer._ec_locations_lock")
        self.ec_lookups = 0
        # the hot-needle RAM cache: SWEED_NCACHE bytes (0, the default, is
        # off), resizable live through POST /admin/ncache
        self.ncache = NeedleCache(tolerant_uint(os.environ.get("SWEED_NCACHE"), 0) or 0)
        self._srv = None
        # the native data plane while it owns the public port; why not, else
        self.turbo = None
        self.turbo_reason = "not started"
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._scrub_thread: Optional[threading.Thread] = None
        # torch.distributed coordinates (SWEED_MESH=1), sent in every
        # heartbeat so the master's fleet scheduler sees the membership
        self.mesh_info: Optional[dict] = None
        self._mesh_group = False  # this server made the default process group

    # -- remote EC shard read through the master's shard lookup -------------
    def _ec_shard_locations(self, vid: int, fresh: bool = False) -> tuple[dict, bool]:
        """shard id -> holder urls of EC volume ``vid``, and whether they
        came from the cache. An answer naming fewer than k shards is not
        kept: no read can be served on it, so the next one asks again."""
        if not fresh:
            with self._ec_locations_lock:
                hit = self._ec_locations.get(vid)
            if hit is not None and time.monotonic() - hit[0] < EC_LOOKUP_TTL_S:
                return hit[1], True
        t = time.monotonic()
        r = http_json("GET", f"http://{self.master_url}/dir/lookup_ec?volumeId={vid}")
        if r.get("_status", 200) >= 500:
            raise IOError(f"lookup_ec {vid}: {r['_status']} {r.get('error', '')}")
        # a 404 is the master's word that no server holds any shard of vid
        locs = {int(sid): list(urls)
                for sid, urls in r.get("shard_id_locations", {}).items() if urls}
        with self._ec_locations_lock:
            self.ec_lookups += 1
            if len(locs) >= DATA_SHARDS:
                self._ec_locations[vid] = (t, locs)
            else:
                self._ec_locations.pop(vid, None)
        return locs, False

    def _forget_ec_locations(self, vid: int, shard_id: Optional[int] = None,
                             holders: frozenset = frozenset()) -> None:
        """Drop vid's cached answer, or only ``holders`` from its list for
        ``shard_id`` when another holder of that shard answered."""
        with self._ec_locations_lock:
            hit = self._ec_locations.pop(vid, None)
            if hit is not None and shard_id is not None:
                t, locs = hit
                locs = dict(locs)
                locs[shard_id] = [u for u in locs.get(shard_id, ()) if u not in holders]
                self._ec_locations[vid] = (t, locs)

    def _remote_shard_reader(self, vid, shard_id, offset, size):
        """The range of shard ``shard_id`` from another server that holds
        it. A holder that refuses, fails or answers short leaves the cached
        answer: the holder alone when another one answered, else the whole
        answer, and then a cached one is checked against the master once
        more. Returns None when every holder named failed; raises
        NoShardHolderError when the master names no other holder."""
        me = f"{self.host}:{self.port}"
        failed: set[str] = set()
        locs, cached = self._ec_shard_locations(vid)
        while True:
            named = [u for u in locs.get(shard_id, ()) if u != me]
            if not named:
                raise NoShardHolderError(f"no server holds shard {vid}.{shard_id}")
            for holder in named:
                if holder in failed:
                    continue
                data = self._shard_range(holder, vid, shard_id, offset, size)
                if data is not None:
                    if failed:
                        self._forget_ec_locations(vid, shard_id, frozenset(failed))
                    return data
                failed.add(holder)
            self._forget_ec_locations(vid)
            if not cached:
                return None
            locs, cached = self._ec_shard_locations(vid, fresh=True)

    @staticmethod
    def _shard_range(holder: str, vid: int, shard_id: int, offset: int,
                     size: int) -> Optional[bytes]:
        """One holder's answer for the range, or None if it refused, failed
        or answered short."""
        try:
            status, data = http_bytes(
                "GET", f"http://{holder}/admin/ec/shard_read?volume={vid}"
                       f"&shard={shard_id}&offset={offset}&size={size}")
        except DeadlineExceeded:
            raise
        except OSError as e:
            glog.V(1).info("shard %d.%d from %s: %s", vid, shard_id, holder, e)
            return None
        return data if status == 200 and len(data) == size else None

    # -- data plane ----------------------------------------------------------
    @staticmethod
    def _parse_fid_path(path: str) -> tuple[int, int, int]:
        """'/3,01637037d6[.ext]' or '/3/01637037d6' -> (vid, needle id,
        cookie); the ``_<delta>`` suffix of batch assigns is honoured."""
        p = path.lstrip("/")
        if "," in p:
            vid_str, fid = p.split(",", 1)
        elif "/" in p:
            vid_str, fid = p.split("/", 1)
        else:
            raise ValueError(f"bad fid path {path!r}")
        if "." in fid:
            fid = fid[: fid.rindex(".")]
        nid, cookie = parse_path(fid)
        return int(vid_str), nid, cookie

    def _auth_ok(self, h, path, q, key: str) -> bool:
        """The JWT must be valid and scoped to the fid being touched
        (volume_server_handlers_write.go maybeCheckJwtAuthorization)."""
        if not key:
            return True
        token = q.get("auth", "")
        ah = h.headers.get("Authorization", "")
        if not token and ah.startswith("Bearer "):
            token = ah[len("Bearer "):]
        return verify_fid_jwt(key, token, _path_fid(path))

    def _h_get(self, h, path, q, body):
        if not self.guard.allowed(h.client_address[0]):
            return 403, {"error": "ip not allowed"}
        if not self._auth_ok(h, path, q, self.jwt_read_key):
            return 401, {"error": "unauthorized read"}
        self._req_count.inc(op="get")
        with self._req_hist.time(op="get"):
            return self._h_get_timed(h, path, q)

    def _h_get_timed(self, h, path, q):
        vid, nid, cookie = self._parse_fid_path(path)
        # ?width=zz or a negative width is ignored, as the reference ignores
        # Atoi failures (resizing.go): such a request is served as if the
        # parameter were absent, Range and gzip included
        width = tolerant_uint(q.get("width"), None) or None
        height = tolerant_uint(q.get("height"), None) or None
        wants_resize = bool(width or height)
        if self.ncache.enabled and not wants_resize:
            cached = self.ncache.get(vid, nid, cookie)
            if cached is not None:
                # a RAM hit is the bytes a disk read of this plain needle
                # gives (mutations invalidate, the cache checks cookies);
                # the heat signal still sees the read
                self.store.note_volume_read(vid)
                rng = h.headers.get("Range", "")
                if rng:
                    return self._range_reply(h, cached, rng)
                h.extra_headers = {"Accept-Ranges": "bytes"}
                return 200, cached
        # fired below the cache: a RAM hit skips the modelled disk read
        faultpoints.fire("volume.read.needle")
        n = Needle(id=nid)
        ext = None
        rng = h.headers.get("Range", "")
        try:
            if rng and not wants_resize:
                resp = self._ec_range_reply(h, vid, nid, cookie, rng)
                if resp is not None:
                    return resp
            # a resize needs the bytes in userspace: never the zero-copy path
            ext = None if wants_resize else self._needle_extent(vid, n)
            if ext is None:
                self.store.read_volume_needle(vid, n)
        except Exception as e:  # noqa: BLE001 — the reference's 404 mapping
            if isinstance(e, (NotFoundError, DeletedError)) or "not in ecx" in str(e):
                return 404, {"error": str(e)}
            raise
        if n.cookie != cookie:
            if ext is not None:
                ext[0].close()
            return 404, {"error": "cookie mismatch"}
        if ext is not None and self.ncache.would_cache(ext[2]) \
                and not n.is_chunk_manifest and not n.is_compressed:
            # populate on a miss: one read of the extent now buys RAM hits
            # after; extents too big for the cache stay zero-copy
            f, data_off, data_len = ext
            try:
                # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
                n.data = os.pread(f.fileno(), data_len, data_off)
            finally:
                f.close()
            self.ncache.put(vid, nid, cookie, bytes(n.data))
            ext = None
        if ext is not None:
            resp = self._sendfile_reply(h, q, n, ext)
            if resp is not None:
                return resp
            # disqualified by the metadata (a chunk manifest to resolve,
            # gzip the client did not ask for): read it buffered
            try:
                self.store.read_volume_needle(vid, n)
            except (NotFoundError, DeletedError) as e:
                return 404, {"error": str(e)}
        data = bytes(n.data)
        if n.is_chunk_manifest and q.get("cm") != "false":
            # server-side chunked-file resolution
            # (volume_server_handlers_read.go:181)
            return self._serve_chunked_manifest(h, data)
        if self.ncache.would_cache(len(data)) and not n.is_compressed \
                and not wants_resize:
            # plain needles only, so a hit needs no metadata decisions
            self.ncache.put(vid, nid, cookie, data)
        serving_gzip = False
        if n.is_compressed:
            # gzip goes out as stored only to clients that asked for it,
            # and never resized: a resize works on the plain bytes
            if "gzip" in h.headers.get("Accept-Encoding", "") and not wants_resize:
                h.extra_headers = {"Content-Encoding": "gzip"}
                serving_gzip = True
            else:
                data = gzip.decompress(data)
        if wants_resize:
            # on-read resize of an image needle (images/resizing.go)
            mime = n.mime.decode() if n.mime else "image/jpeg"
            data = images.resized(data, mime, width, height, q.get("mode", ""))
        if rng and not wants_resize and not serving_gzip:  # ranges address the plain bytes
            return self._range_reply(h, data, rng)
        h.extra_headers = (h.extra_headers or {}) | {"Accept-Ranges": "bytes"}
        return 200, data

    def _ec_range_reply(self, h, vid: int, nid: int, cookie: int, rng: str):
        """A Range on a needle of an EC volume, answered from the bytes it
        needs (``Store.ec_needle_reader``): the header and data size, the
        flags byte and the range, so a lost shard is reconstructed only
        where they lie. None for what the whole-needle read serves: a plain
        volume, a version 1 record, a record no larger than a small block
        (it lies in at most two intervals, which that read takes whole), a
        compressed needle, a chunk manifest, a range that is malformed or
        covers all of the data. Unlike that read, this one cannot check the
        needle's CRC, which covers all of its data."""
        if self.store.find_volume(vid) is not None:
            return None
        ev = self.store.find_ec_volume(vid)
        if ev is None or ev.version == VERSION1:
            return None
        # the read counts once for the heat, as in the whole-needle read:
        # here unless that read takes over
        try:
            resp = self._ec_range_read(h, ev, nid, cookie, rng)
        except Exception:
            self.store.note_ec_read(vid)
            raise
        if resp is not None:
            self.store.note_ec_read(vid)
        return resp

    def _ec_range_read(self, h, ev, nid: int, cookie: int, rng: str):
        reader = self.store.ec_needle_reader(ev, nid)
        if reader.record_size <= SMALL_BLOCK_SIZE:
            return None
        head_len = NEEDLE_HEADER_SIZE + 4  # the header, then the data size
        head = reader.read([(0, head_len)])[0]
        found = Needle()
        found.parse_header(head)
        if found.id != nid:
            raise EcNotFoundError(f"unexpected needle {found.id:x} != {nid:x}")
        if found.size != reader.size:
            return None  # the whole read reports the mismatch
        if found.cookie != cookie:
            return 404, {"error": "cookie mismatch"}
        data_size = int.from_bytes(head[NEEDLE_HEADER_SIZE:head_len], "big")
        if data_size + 4 >= reader.size:
            return None  # a corrupt length: the whole read reports it
        parsed = parse_byte_range(rng, data_size)
        spans = [(head_len + data_size, 1)]  # the flags byte
        partial = isinstance(parsed, tuple) and parsed != (0, data_size - 1)
        if partial:
            start, end = parsed
            spans.append((head_len + start, end - start + 1))
        pieces = reader.read(spans)
        if pieces[0][0] & (FLAG_IS_COMPRESSED | FLAG_IS_CHUNK_MANIFEST):
            return None
        if parsed == "unsatisfiable":
            h.extra_headers = unsatisfiable_range_headers(data_size)
            return 416, b""
        if not partial:
            return None
        h.extra_headers = range_headers(start, end, data_size)
        return 206, pieces[1]

    def _needle_extent(self, vid: int, n: Needle):
        """The zero-copy read setup (``Store.read_volume_needle_extent``),
        or None for the buffered path (sendfile off, or the needle does not
        qualify)."""
        min_size = sendfile_min_bytes()
        if min_size is None:
            return None
        return self.store.read_volume_needle_extent(vid, n, min_size)

    def _sendfile_reply(self, h, q, n: Needle, ext):
        """The zero-copy reply for a qualified extent, or None (the file
        closed) when the metadata disqualifies it: a chunk manifest to
        resolve, gzip the client did not ask for."""
        f, data_off, data_len = ext
        if n.is_chunk_manifest and q.get("cm") != "false":
            f.close()
            return None
        serving_gzip = False
        if n.is_compressed:
            if "gzip" not in h.headers.get("Accept-Encoding", ""):
                f.close()
                return None
            serving_gzip = True
        rng = h.headers.get("Range", "")
        if rng and not serving_gzip:  # ranges address the plain bytes
            parsed = parse_byte_range(rng, data_len)
            if parsed == "unsatisfiable":
                f.close()
                h.extra_headers = unsatisfiable_range_headers(data_len)
                return 416, b""
            if parsed is not None:
                start, end = parsed
                h.extra_headers = range_headers(start, end, data_len)
                return 206, SendfileBody(f, data_off + start, end - start + 1)
        h.extra_headers = {"Accept-Ranges": "bytes"}
        if serving_gzip:
            h.extra_headers["Content-Encoding"] = "gzip"
        return 200, SendfileBody(f, data_off, data_len)

    async def _h_get_native(self, h, path, q):
        """The hot GET/HEAD on the aio core's loop: cache hits and
        sendfile-qualified extents with no worker-thread hop. Every edge
        (guard, auth, a lookup error, a cookie mismatch, a cache populate,
        a chunk manifest, gzip the client will not take, a small needle)
        falls back to the bridged ``_h_get``, which gives the canonical
        bytes."""
        if not self.guard.allowed(h.client_address[0]):
            return NATIVE_FALLBACK
        if not self._auth_ok(h, path, q, self.jwt_read_key):
            return NATIVE_FALLBACK
        try:
            vid, nid, cookie = self._parse_fid_path(path)
        except ValueError:
            return NATIVE_FALLBACK
        if tolerant_uint(q.get("width"), None) or tolerant_uint(q.get("height"), None):
            return NATIVE_FALLBACK  # a resize needs the bytes in userspace
        t0 = time.monotonic()
        if self.ncache.enabled:
            cached = self.ncache.get(vid, nid, cookie)
            if cached is not None:
                self._req_count.inc(op="get")
                self.store.note_volume_read(vid)
                rng = h.headers.get("Range", "")
                if rng:
                    resp = self._range_reply(h, cached, rng)
                else:
                    h.extra_headers = {"Accept-Ranges": "bytes"}
                    resp = (200, cached)
                self._req_hist.observe(time.monotonic() - t0, op="get")
                return resp
        n = Needle(id=nid)
        try:
            ext = self._needle_extent(vid, n)
        except Exception:  # noqa: BLE001 — the bridge renders the canonical 404/500
            return NATIVE_FALLBACK
        if ext is None:
            return NATIVE_FALLBACK  # a small needle: buffered path (and populate)
        if n.cookie != cookie:
            ext[0].close()
            return NATIVE_FALLBACK
        if self.ncache.would_cache(ext[2]) and not n.is_chunk_manifest \
                and not n.is_compressed:
            ext[0].close()  # the populate belongs to the bridged path
            return NATIVE_FALLBACK
        resp = self._sendfile_reply(h, q, n, ext)
        if resp is None:
            return NATIVE_FALLBACK
        self._req_count.inc(op="get")
        self._req_hist.observe(time.monotonic() - t0, op="get")
        return resp

    @staticmethod
    def _range_reply(h, data: bytes, rng: str):
        """Single-range Range semantics over needle bytes
        (volume_server_handlers_read.go processRangeRequest)."""
        total = len(data)
        parsed = parse_byte_range(rng, total)
        if parsed is None:
            h.extra_headers = {"Accept-Ranges": "bytes"}
            return 200, data
        if parsed == "unsatisfiable":
            h.extra_headers = unsatisfiable_range_headers(total)
            return 416, b""
        start, end = parsed
        h.extra_headers = range_headers(start, end, total)
        return 206, data[start: end + 1]

    def _serve_chunked_manifest(self, h, manifest_bytes: bytes):
        """Concatenate a chunked file from its manifest
        (operation/chunked_file.go; volume_server_handlers_read.go:181-200).
        A ranged read fetches only the chunks it overlaps."""
        mf = json.loads(_maybe_decompress(manifest_bytes))
        headers = {}
        if mf.get("mime"):
            headers["Content-Type"] = mf["mime"]
        total = mf.get("size", 0)
        if h.command == "HEAD":
            h.extra_headers = headers | {"Content-Length": str(total),
                                         "Accept-Ranges": "bytes"}
            return 200, b""
        rng = h.headers.get("Range", "")
        parsed = parse_byte_range(rng, total) if rng else None
        if parsed == "unsatisfiable":
            h.extra_headers = unsatisfiable_range_headers(total)
            return 416, b""
        start, end = parsed if parsed is not None else (0, total - 1)
        out = bytearray(end - start + 1)
        for c in mf.get("chunks", []):
            c_start, c_end = c["offset"], c["offset"] + c["size"] - 1
            if c_end < start or c_start > end:
                continue
            status, piece = self._fetch_fid(c["fid"])
            if status != 200:
                return 500, {"error": f"chunk {c['fid']}: HTTP {status}"}
            lo, hi = max(start, c_start), min(end, c_end)
            out[lo - start: hi - start + 1] = piece[lo - c_start: hi - c_start + 1]
        if parsed is not None:
            h.extra_headers = headers | range_headers(start, end, total)
            return 206, bytes(out)
        h.extra_headers = headers | {"Accept-Ranges": "bytes"}
        return 200, bytes(out)

    def _lookup(self, vid: int) -> list[str]:
        r = http_json("GET", f"http://{self.master_url}/dir/lookup?volumeId={vid}")
        return [loc["url"] for loc in r.get("locations", [])]

    def _fetch_fid(self, fid: str) -> tuple[int, bytes]:
        """Read a fid wherever it lives: the local store first, then the
        holders the master names (chunks may sit on other servers)."""
        try:
            f = FileId.parse(fid)
        except ValueError:
            return 400, b""
        if self.store.find_volume(f.volume_id) is not None:
            n = Needle(id=f.key)
            try:
                self.store.read_volume_needle(f.volume_id, n)
            except Exception:  # noqa: BLE001 — any failure reads as absent
                return 404, b""
            if n.cookie != f.cookie:
                return 404, b""
            data = bytes(n.data)
            return 200, gzip.decompress(data) if n.is_compressed else data
        auth = read_auth_query(self.jwt_read_key, fid)
        try:
            urls = self._lookup(f.volume_id)
        except OSError:
            urls = []
        for url in urls:
            status, data = http_bytes("GET", f"http://{url}/{fid}{auth}")
            if status == 200:
                return status, data
        return 404, b""

    @JsonHandler.mark_reply_span
    def _h_query(self, h, path, q, body):
        """Data-local query: run an S3-Select-ish request against a needle
        this server holds, without shipping the bytes anywhere
        (volume_grpc_query.go:12; the filer delegates single-chunk queries
        here). A query returns needle content, so it passes the same IP
        guard and fid-scoped read JWT as a GET."""
        if not self.guard.allowed(h.client_address[0]):
            return 403, {"error": "ip not allowed"}
        req = json.loads(body)
        fid = req.get("fid", "")
        if self.jwt_read_key:
            token = req.get("auth", "") or q.get("auth", "")
            ah = h.headers.get("Authorization", "")
            if not token and ah.startswith("Bearer "):
                token = ah[len("Bearer "):]
            if not verify_fid_jwt(self.jwt_read_key, token, fid):
                return 401, {"error": "unauthorized read"}
        try:
            vid = int(fid.split(",")[0])
        except (ValueError, IndexError):
            return 400, {"error": f"bad fid {fid!r}"}
        if self.store.find_volume(vid) is None and self.store.find_ec_volume(vid) is None:
            return 404, {"error": f"volume {vid} not local"}
        with trace.start_span("daemon.needle_read", service="volume") as span:
            status, data = self._fetch_fid(fid)
            if span is not None:
                span.tags["bytes"] = len(data)
        if status != 200:
            return status, {"error": f"needle {fid}: HTTP {status}"}
        with self._query_lock:
            # this server's own scans: the filer's pushdown is told apart by
            # them where several servers share a process (and its counters)
            self.queries_served += 1
        return execute_request(data, req, backend=self.store.device_backend)

    def _h_post(self, h, path, q, body):
        if not self.guard.allowed(h.client_address[0]):
            return 403, {"error": "ip not allowed"}
        if not self._auth_ok(h, path, q, self.jwt_signing_key):
            return 401, {"error": "unauthorized write"}
        self._req_count.inc(op="put")
        with self._req_hist.time(op="put"):
            return self._h_post_timed(h, path, q, body)

    def _h_post_timed(self, h, path, q, body):
        faultpoints.fire("volume.write.needle")
        vid, nid, cookie = self._parse_fid_path(path)
        n = Needle(cookie=cookie, id=nid, data=bytes(body))
        if h.headers.get("Content-Encoding") == "gzip":
            # pre-compressed by the client (needle_parse_upload.go:75): kept
            # as is and flagged, so reads know to decompress
            n.set_flag(FLAG_IS_COMPRESSED)
        if h.headers.get("X-Sweed-Chunk-Manifest") == "true":
            n.set_flag(FLAG_IS_CHUNK_MANIFEST)
        name = h.headers.get("X-Sweed-Name")
        if name:
            # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
            n.name = name.encode()[:255]
            n.set_flag(FLAG_HAS_NAME)
        mime = h.headers.get("X-Sweed-Mime")
        if mime:
            # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
            n.mime = mime.encode()[:255]
            n.set_flag(FLAG_HAS_MIME)
        # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
        n.last_modified = int(time.time())
        n.set_flag(FLAG_HAS_LAST_MODIFIED)
        if q.get("ttl"):
            # sweedlint: ok cross-domain-race per-request Needle; one request path builds it, never shared across domains
            n.ttl = read_ttl(q["ttl"])
            n.set_flag(FLAG_HAS_TTL)
        _, _, unchanged = self.store.write_volume_needle(
            vid, n, fsync=q.get("fsync") == "true")
        # an overwrite makes a cached copy stale (the rollback delete of a
        # failed fan-out comes through _h_delete's invalidation too)
        self.ncache.invalidate(vid, nid)
        if q.get("type") != "replicate":
            err = self._replicate(path, q, body, h, "POST")
            if err:
                # all replicas or none (store_replicate.go:21)
                self.store.delete_volume_needle(vid, Needle(cookie=cookie, id=nid))
                self.ncache.invalidate(vid, nid)
                return 500, {"error": f"replication failed: {err}"}
        return 201, {"size": len(body), "eTag": n.etag(), "unchanged": unchanged}

    def _h_delete(self, h, path, q, body):
        if not self.guard.allowed(h.client_address[0]):
            return 403, {"error": "ip not allowed"}
        if not self._auth_ok(h, path, q, self.jwt_signing_key):
            return 401, {"error": "unauthorized delete"}
        vid, nid, cookie = self._parse_fid_path(path)
        # a manifest's chunk list is read before it is deleted, but its
        # chunks go only after the manifest's delete (replicas included)
        # succeeded, and only from the primary
        # (volume_server_handlers_write.go DeleteHandler)
        chunk_fids: list[str] = []
        if q.get("type") != "replicate":
            probe = Needle(id=nid)
            try:
                self.store.read_volume_needle(vid, probe)
            except Exception:  # noqa: BLE001 — absent, deleted or unreadable
                probe = None
            if probe is not None and probe.cookie == cookie and probe.is_chunk_manifest:
                try:
                    mf = json.loads(_maybe_decompress(bytes(probe.data)))
                    chunk_fids = [c["fid"] for c in mf.get("chunks", [])]
                except (ValueError, KeyError, TypeError) as e:
                    glog.warning("manifest parse vid %d: %s", vid, e)
        size = self.store.delete_volume_needle(vid, Needle(cookie=cookie, id=nid))
        self.ncache.invalidate(vid, nid)
        if q.get("type") != "replicate":
            err = self._replicate(path, q, b"", h, "DELETE")
            if err:
                return 500, {"error": f"replicated delete failed: {err}"}
            if chunk_fids:
                self._delete_chunks(chunk_fids)
        return 202, {"size": size}

    def _delete_chunks(self, fids: list[str]) -> None:
        """A manifest's data chunks, grouped by volume, go to every holder
        as one /_batch_delete (operation.delete_files, delete_content.go:32).
        Best effort: a chunk left behind is garbage, not lost data."""
        by_vid: dict[int, list[str]] = defaultdict(list)
        for fid in fids:
            try:
                by_vid[FileId.parse(fid).volume_id].append(fid)
            except ValueError:
                continue
        for vid, group in by_vid.items():
            auths = ({fid: gen_jwt(self.jwt_signing_key, fid) for fid in group}
                     if self.jwt_signing_key else {})
            try:
                for url in self._lookup(vid):
                    http_json("POST", f"http://{url}/_batch_delete",
                              {"fids": group, "auths": auths})
            except OSError as e:
                glog.warning("chunk cascade vid %d: %s", vid, e)

    def _replicate(self, path, q, body, h, method) -> Optional[str]:
        """Fan a write or delete out to the volume's other replicas
        (distributedOperation, store_replicate.go:95). Returns the errors,
        or None when every replica took it."""
        vid = int(path.lstrip("/").split(",")[0].split("/")[0])
        me = {self.store.public_url, f"{self.host}:{self.port}"}
        # replicas carry the same name/mime/compression flags as the primary
        fwd = {k: v for k, v in h.headers.items()
               if k.title() in ("X-Sweed-Name", "X-Sweed-Mime", "Content-Encoding",
                                "X-Sweed-Chunk-Manifest")}
        extra = "&".join(f"{k}={v}" for k, v in q.items() if k not in ("type", "auth"))
        if self.jwt_signing_key:
            tok = gen_jwt(self.jwt_signing_key, _path_fid(path))
            extra = (extra + "&" if extra else "") + f"auth={tok}"
        errors = []
        for url in self._lookup(vid):
            if url in me:
                continue
            full = f"http://{url}{path}?type=replicate" + (f"&{extra}" if extra else "")
            status, resp = http_bytes(method, full, body if method == "POST" else None,
                                      headers=fwd)
            if status >= 300:
                errors.append(f"{url}: {status} {resp[:100]!r}")
        return "; ".join(errors) if errors else None

    def _h_batch_delete(self, h, path, q, body):
        """BatchDelete rpc (delete_content.go:32): delete many local needles
        in one request, with a result per fid. Local only: the client sends
        the batch to every replica itself."""
        if not self.guard.allowed(h.client_address[0]):
            return 403, {"error": "ip not allowed"}
        req = json.loads(body)
        auths = req.get("auths", {})
        results = []
        for fid in req.get("fids", []):
            item = {"fid": fid}
            results.append(item)
            try:
                vid, nid, cookie = self._parse_fid_path("/" + fid)
            except ValueError as e:
                item.update(status=400, error=f"bad fid: {e}")
                continue
            if self.jwt_signing_key and not verify_fid_jwt(
                    self.jwt_signing_key, auths.get(fid, ""), fid.replace("/", ",")):
                item.update(status=401, error="unauthorized delete")
                continue
            # a manifest must take the single-fid DELETE, so that its chunks
            # go with it (the reference's BatchDelete refuses it the same way)
            probe = Needle(id=nid)
            try:
                self.store.read_volume_needle(vid, probe)
            except Exception:  # noqa: BLE001 — absent, deleted or unreadable
                probe = None
            if probe is not None and probe.is_chunk_manifest:
                item.update(status=409, error="chunk manifest: not allowed in batch delete")
                continue
            try:
                size = self.store.delete_volume_needle(vid, Needle(cookie=cookie, id=nid))
                self.ncache.invalidate(vid, nid)
            except NotFoundError:
                item.update(status=404, error=f"volume {vid} not found")
            except Exception as e:  # noqa: BLE001 — one fid's failure stays its own
                item.update(status=500, error=str(e))
            else:
                item.update(status=202, size=size)
        return 200, {"results": results}

    # -- admin: volumes ------------------------------------------------------
    def _h_assign_volume(self, h, path, q, body):
        self.store.add_volume(_q_req_uint(q, "volume"),
                              collection=q.get("collection", ""),
                              replica_placement=q.get("replication") or "000",
                              ttl=q.get("ttl", ""))
        return 200, {}

    def _h_delete_volume(self, h, path, q, body):
        vid = _q_req_uint(q, "volume")
        ok = self.store.delete_volume(vid)
        if ok:
            self.store.clear_corrupt(vid)
        return 200, {"deleted": ok}

    def _h_readonly(self, h, path, q, body):
        ok = self.store.mark_volume_readonly(_q_req_uint(q, "volume"))
        return (200, {}) if ok else (404, {"error": "volume not found"})

    def _h_writable(self, h, path, q, body):
        ok = self.store.mark_volume_writable(_q_req_uint(q, "volume"))
        return (200, {}) if ok else (404, {"error": "volume not found"})

    def _h_volume_unmount(self, h, path, q, body):
        """Stop serving a volume, keep its files (VolumeUnmount)."""
        vid = _q_req_uint(q, "volume")
        if self.store.unmount_volume(vid):
            return 200, {"unmounted": vid}
        return 404, {"error": "volume not found"}

    def _h_volume_mount(self, h, path, q, body):
        """(Re)load one volume from disk and announce it (VolumeMount)."""
        vid = _q_req_uint(q, "volume")
        already = self.store.find_volume(vid) is not None
        if self.store.mount_volume(vid) is None:
            return 404, {"error": f"no volume {vid} files on disk"}
        return 200, {"mounted": vid, "already": already}

    def _h_vacuum_check(self, h, path, q, body):
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        return 200, {"garbage_ratio": v.garbage_level()}

    def _h_vacuum(self, h, path, q, body):
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        v.compact(bytes_per_second=_q_uint(q, "compactionBytePerSecond", 0))
        return 200, {"size": v.size()}

    def _h_volume_copy(self, h, path, q, body):
        """Pull a whole volume (.dat/.idx) from a source server and load it
        (VolumeCopy rpc, volume_grpc_copy.go). Each file is held in memory
        whole, as the reference's does."""
        vid = _q_req_uint(q, "volume")
        source = q.get("source")
        if not source:
            raise BadRequest("source= required")
        collection = q.get("collection", "")
        if self.store.find_volume(vid) is not None:
            return 409, {"error": f"volume {vid} already here"}
        loc = self.store.locations[0]
        base = volume_file_name(loc.directory, collection, vid)
        for ext in (".dat", ".idx"):
            status, data = http_bytes(
                "GET", f"http://{source}/admin/file?volume={vid}"
                       f"&collection={collection}&ext={ext}")
            if status != 200:
                return 500, {"error": f"fetch {ext}: {status}"}
            with open(base + ext, "wb") as f:
                f.write(data)
        loc.load_existing_volumes()
        v = self.store.find_volume(vid)
        if v is None:
            return 500, {"error": "volume copied but failed to load"}
        # a fresh replica supersedes any scrub findings on the old bytes
        self.store.clear_corrupt(vid)
        # an instant delta beat announces the new replica
        self.store.queue_new_volume(v)
        return 200, {}

    def _h_tail(self, h, path, q, body):
        """Records appended after since_ns as frames of [4-byte length]
        [record] (VolumeTailSender), at most max_bytes of frames a reply;
        callers loop until an empty body."""
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        since = _q_uint(q, "since_ns", 0)
        max_bytes = _q_uint(q, "max_bytes", 8 * 1024 * 1024)
        out = bytearray()
        last_ns = since
        full = False
        for n in v.tail_needles(since):
            if full and n.append_at_ns != last_ns:
                break
            blob = n.to_bytes(v.version)
            out += len(blob).to_bytes(4, "big") + blob
            last_ns = n.append_at_ns
            # over the page budget, the current group of equal time stamps
            # still ends here: the next page resumes at append_at_ns > since,
            # so a split group would lose its tail
            if len(out) >= max_bytes:
                full = True
        h.extra_headers = {"X-Volume-Version": str(v.version),
                           "X-Last-Append-Ns": str(last_ns)}
        return 200, bytes(out)

    def _h_volume_status(self, h, path, q, body):
        """A volume's size, version and compaction revision, for backup and
        copy clients."""
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        return 200, {
            "volume": v.id,
            "size": v.size(),
            "version": v.version,
            "compaction_revision": v.super_block.compaction_revision,
            "last_append_at_ns": v.last_append_at_ns,
            "file_count": v.file_count(),
            "read_only": v.read_only,
        }

    def _h_incremental_copy(self, h, path, q, body):
        """Raw .dat bytes from ``offset``, at most ``max_bytes`` (64 MiB at
        most) a reply (VolumeIncrementalCopy rpc)."""
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        offset = _q_uint(q, "offset", 0)
        max_bytes = min(_q_uint(q, "max_bytes", 8 * 1024 * 1024), 64 * 1024 * 1024)
        size = v.size()
        n = max(0, min(size - offset, max_bytes))
        data = v.data_backend.read_at(offset, n) if n else b""
        h.extra_headers = {
            "X-Volume-Version": str(v.version),
            "X-Dat-Size": str(size),
            "X-Compaction-Revision": str(v.super_block.compaction_revision),
        }
        return 200, data

    def _h_tier_upload(self, h, path, q, body):
        """Seal a volume and move its .dat to an S3-class backend
        (volume_grpc_tier_upload.go): ``endpoint`` and ``bucket`` with
        inline ``accessKey``/``secretKey``, or a ``backend`` named in
        backend.toml; ``skipUpload=true`` verifies the object another replica
        uploaded."""
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        if not q.get("bucket"):
            raise BadRequest("bucket= required")
        return 200, v.tier_upload(
            q.get("endpoint", ""), q["bucket"], access_key=q.get("accessKey", ""),
            secret_key=q.get("secretKey", ""), keep_local=q.get("keepLocal") == "true",
            skip_upload=q.get("skipUpload") == "true", backend=q.get("backend", ""))

    def _h_tier_download(self, h, path, q, body):
        """Fetch a tiered volume's .dat back (volume_grpc_tier_download.go)."""
        v = self.store.find_volume(_q_req_uint(q, "volume"))
        if v is None:
            return 404, {"error": "volume not found"}
        v.tier_download(access_key=q.get("accessKey", ""), secret_key=q.get("secretKey", ""))
        # local again: the engine may own its reads (the JAX server leaves
        # a recalled volume in Python)
        self.store.attach_turbo_volume(v)
        return 200, {"ok": True}

    def _h_volume_configure_replication(self, h, path, q, body):
        """Rewrite the super block's replica-placement byte (VolumeConfigure,
        command_volume_configure_replication.go): on disk or not at all."""
        vid = _q_req_uint(q, "volume")
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": "volume not found"}
        rp = ReplicaPlacement.from_string(q.get("replication", "000"))
        old_msg = self.store._volume_message(v)
        with v._lock:
            old = v.super_block.replica_placement
            v.super_block.replica_placement = rp
            try:
                v.data_backend.write_at(0, v.super_block.to_bytes())
                # sweedlint: ok blocking-under-lock persist-or-nothing placement write; fsync under the volume lock is the point
                v.data_backend.sync()
            except Exception:
                # memory must not advertise a placement the disk never got
                v.super_block.replica_placement = old
                raise
        if v.turbo is not None:
            # the engine takes a volume's writes over HTTP only while it has
            # no replica to fan out to: attach it again under the new
            # placement (the JAX server keeps the old decision, so a volume
            # raised to 001 kept taking native writes that no replica got)
            v.detach_turbo()
            self.store.attach_turbo_volume(v)
        # the master files a volume by its placement: withdraw it from the
        # old one and announce it under the new, as the reference's
        # unmount, configure, mount does (volume_grpc_admin.go
        # VolumeConfigure); the re-announce alone left the master's lookup
        # on the old layout's holders
        self.store.queue_deleted_volume(old_msg)
        self.store.queue_new_volume(v)
        return 200, {"volume": vid, "replication": str(rp)}

    def _h_server_leave(self, h, path, q, body):
        """Stop heartbeating and scrubbing, and deregister from the master
        now (VolumeServerLeave)."""
        self._stop.set()
        self.store.delta_event.set()  # wake the beat loop so it exits
        # a beat landing after the master processed the leave would
        # register this server again: wait the loop out first
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=12)
        self._join_scrub()
        try:
            http_json("POST", f"http://{self.master_url}/cluster/leave"
                              f"?url={self.host}:{self.port}")
        except OSError as e:  # the master may be down
            glog.warning("leave notify failed: %s", e)
        return 200, {"left": f"{self.host}:{self.port}"}

    def _h_file(self, h, path, q, body):
        """A raw volume or shard file (CopyFile rpc)."""
        vid = _q_req_uint(q, "volume")
        collection = q.get("collection", "")
        ext = q.get("ext", "")
        if ext in (".dat", ".idx"):
            v = self.store.find_volume(vid)
            if v is not None:
                v.sync()  # the copy must hold every acknowledged write
        for loc in self.store.locations:
            p = volume_file_name(loc.directory, collection, vid) + ext
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return 200, f.read()
        return 404, {"error": f"{vid}{ext} not found"}

    def _h_needle_ids(self, h, path, q, body):
        """Live needle keys of a volume (volume.fsck's raw material,
        command_volume_fsck.go)."""
        vid = _q_req_uint(q, "volume")
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        with_cookies = q.get("cookies") == "true"
        out = []

        def visit(nv):
            if nv.size < 0 or nv.offset == 0:
                return
            rec = {"key": nv.key, "size": nv.size}
            if with_cookies:
                rec["cookie"] = int.from_bytes(v.data_backend.read_at(nv.offset, 4), "big")
            out.append(rec)

        v.nm.ascending_visit(visit)
        return 200, {"volume": vid, "needles": out}

    def _h_needle_info(self, h, path, q, body):
        """One needle's index entry and append time (fsck's purge check
        skips in-flight uploads by it)."""
        vid = _q_req_uint(q, "volume")
        key = _q_req_uint(q, "key")
        v = self.store.find_volume(vid)
        if v is None:
            return 404, {"error": f"volume {vid} not found"}
        nv = v.nm.get(key)
        if nv is None or nv.offset == 0:
            return 404, {"error": f"needle {key:x} not found"}
        append_ns = 0
        if nv.size >= 0 and v.version >= 3:
            blob = v.data_backend.read_at(nv.offset, get_actual_size(nv.size, v.version))
            try:
                append_ns = Needle.from_bytes(blob, nv.size, v.version,
                                              verify_crc=False).append_at_ns
            # sweedlint: ok broad-except status probe; append_ns stays 0 for an unreadable needle
            except Exception:  # noqa: BLE001 — an unreadable record leaves append_ns 0
                pass
        return 200, {"key": key, "offset": nv.offset, "size": nv.size,
                     "append_ns": append_ns}

    def _h_status(self, h, path, q, body):
        hb = self.store.collect_heartbeat()
        hb["ec"] = self.store.collect_ec_heartbeat()["ec_shards"]
        hb["heat"] = heat_stats()
        hb["ncache"] = self.ncache.stats()
        hb["scrub"] = scrub_stats()
        # request-latency quantiles from the histogram /metrics exposes
        hb["request_latency"] = {"get": self._req_hist.summary(op="get"),
                                 "put": self._req_hist.summary(op="put")}
        hb["turbo"] = self.turbo_status()
        hb["serving"] = SERVING.snapshot()
        with self._query_lock:
            hb["queries_served"] = self.queries_served
        hb["trace"] = trace.trace_stats()
        # the process's launches of the GF(2^8) kernel (every EC step and
        # degraded read of every store in this process): how a run of the
        # CLI's daemons shows that its EC work reached the card
        hb["gf_matmul"] = {"launches": gf_matmul.launches}
        return 200, hb

    def turbo_status(self) -> dict:
        """Whether the native engine owns the public port, and why not."""
        if self.turbo is not None:
            return {"on": True, "reason": "", "threads": self.turbo.threads,
                    "counters": self.turbo.counters()}
        return {"on": False, "reason": self.turbo_reason}

    def _h_metrics(self, h, path, q, body):
        out = default_registry.expose()
        if self.turbo is not None:
            # the engine serves its ops without touching the Python
            # counters: its tallies go alongside
            c = self.turbo.counters()
            out += (
                "# HELP volume_server_turbo_requests_total requests served "
                "by the native data plane\n"
                "# TYPE volume_server_turbo_requests_total counter\n"
                f'volume_server_turbo_requests_total{{op="get"}} {c["gets"]}\n'
                f'volume_server_turbo_requests_total{{op="post"}} {c["posts"]}\n'
                f'volume_server_turbo_requests_total{{op="delete"}} {c["deletes"]}\n'
                f'volume_server_turbo_requests_total{{op="proxied"}} {c["proxied"]}\n'
            )
        return 200, out.encode()

    def _h_ncache(self, h, path, q, body):
        """Resize the hot-needle cache's byte budget live (?capacity=<bytes>
        or a JSON body; 0 disables)."""
        cap = q.get("capacity")
        if cap is None and body:
            cap = json.loads(body).get("capacity")
        if cap is not None:
            self.ncache.set_capacity(_q_req_uint({"capacity": cap}, "capacity"))
        return 200, self.ncache.stats()

    def _h_ui(self, h, path, q, body):
        """The embedded status page (server/volume_server_ui analog)."""
        hb = self.store.collect_heartbeat()
        h.extra_headers = {"Content-Type": "text/html; charset=utf-8"}
        return 200, render_status_page(
            f"seaweedfs_tpu_torch volume server {self.host}:{self.port}",
            {
                "Server": {
                    "master": self.master_url,
                    "data_center": self.data_center,
                    "rack": self.rack,
                    "max_volume_count": self.max_volume_count,
                    "needle_map_kind": self.store.needle_map_kind,
                    "ec_backend": self.store.ec_backend,
                },
                "Volumes": hb["volumes"],
                "EC shards": self.store.collect_ec_heartbeat()["ec_shards"],
                "Turbo": self.turbo_status(),
                "Heat": heat_stats(),
                "Hot-needle cache": self.ncache.stats(),
                "Scrub": scrub_stats(),
            },
        )

    # -- admin: EC (volume_grpc_erasure_coding.go) ---------------------------
    def _find_base(self, vid: int) -> Optional[str]:
        """The volume's base path: a live volume's, else the one whose .ecx
        is on disk (shards copied in become visible at /admin/ec/mount)."""
        v = self.store.find_volume(vid)
        if v is not None:
            return v.file_name()
        for loc in self.store.locations:
            for name in os.listdir(loc.directory):
                if not name.endswith(".ecx"):
                    continue
                try:
                    _, v_id = parse_volume_base_name(name[:-4])
                except ValueError:
                    continue
                if v_id == vid:
                    return os.path.join(loc.directory, name[:-4])
        return None

    def _h_ec_generate(self, h, path, q, body):
        """VolumeEcShardsGenerate (volume_grpc_erasure_coding.go:39): seal the
        volume and stripe it into 14 shards + .ecx + .vif under the staged
        commit (Store.ec_encode_volume)."""
        vid = _q_req_uint(q, "volume")
        v = self.store.find_volume(vid)
        nbytes = v.size() if v is not None else 0
        t0 = time.monotonic()
        try:
            shards = self.store.ec_encode_volume(vid)
        except NotFoundError:
            return 404, {"error": "volume not found"}
        # bytes and seconds give the caller the encode rate without a
        # second round trip
        return 200, {"shards": shards, "bytes": nbytes, "seconds": time.monotonic() - t0}

    def _h_ec_rebuild(self, h, path, q, body):
        vid = _q_req_uint(q, "volume")
        base = self._find_base(vid)
        if base is None:
            return 404, {"error": "ec volume not found"}
        t0 = time.monotonic()
        generated = encoder.rebuild_ec_files(base, self.store.ec_codec)
        rebuild_ecx_file(base)
        # rebuilt shards are fresh bytes: drop any scrub findings on them
        self.store.clear_corrupt(vid, shard_ids=generated)
        return 200, {"rebuilt_shards": generated, "seconds": time.monotonic() - t0}

    def _h_ec_copy(self, h, path, q, body):
        """Pull shard files (and the .ecx/.vif unless told not to) from a
        source server (VolumeEcShardsCopy, :104)."""
        vid = _q_req_uint(q, "volume")
        source = q.get("source")
        if not source:
            raise BadRequest("source= required")
        shard_ids = _q_shards(q)
        collection = q.get("collection", "")
        base = volume_file_name(self.store.locations[0].directory, collection, vid)
        exts = [shard_ext(s) for s in shard_ids]
        if q.get("copy_ecx", "true") == "true":
            exts.append(".ecx")
        if q.get("copy_vif", "true") == "true":
            exts.append(".vif")
        copied = []
        for ext in exts:
            status, data = http_bytes(
                "GET", f"http://{source}/admin/file?volume={vid}"
                       f"&collection={collection}&ext={ext}")
            if status != 200:
                if ext == ".vif":
                    continue
                return 500, {"error": f"fetch {ext} from {source}: {status}"}
            # staged and renamed: a crash mid-fetch leaves a .tmp that the
            # startup scan collects, never a short shard under its name
            atomic_write(base + ext, data)
            copied.append(ext)
        self.store.clear_corrupt(vid, shard_ids=shard_ids)
        return 200, {"copied": copied}

    def _h_ec_shard_read(self, h, path, q, body):
        vid = _q_req_uint(q, "volume")
        sid = _q_req_uint(q, "shard")
        offset, size = _q_req_uint(q, "offset"), _q_req_uint(q, "size")
        ev = self.store.find_ec_volume(vid)
        shard = ev.shards.get(sid) if ev is not None else None
        if shard is None:
            return 404, {"error": f"shard {vid}.{sid} not here"}
        return 200, shard.read_at(offset, size)

    def _h_ec_to_volume(self, h, path, q, body):
        """VolumeEcShardsToVolume: decode the local shards back into a plain
        .dat/.idx volume and serve it."""
        vid = _q_req_uint(q, "volume")
        base = self._find_base(vid)
        if base is None or not os.path.exists(base + ".ecx"):
            return 404, {"error": f"no local ec volume {vid}"}
        t0 = time.monotonic()
        dat_size = decode_to_volume(base, codec=self.store.ec_codec)
        seconds = time.monotonic() - t0
        # the EC registration and its files go before the rescan: shard
        # files left on disk would make the rescan mount the EcVolume again
        # and the next full heartbeat announce shards the master was told
        # are gone
        ev = self.store.find_ec_volume(vid)
        bits = sum(1 << s for s in ev.shard_ids()) if ev else 0
        collection = ev.collection if ev else q.get("collection", "")
        for loc in self.store.locations:
            loc.unload_ec_volume(vid)
        for name in [shard_ext(s) for s in range(TOTAL_SHARDS)] + [".ecx", ".ecj"]:
            try:
                os.remove(base + name)
            except FileNotFoundError:
                pass
        if bits:
            self.store.queue_deleted_ec_shards(vid, collection, bits)
        for loc in self.store.locations:
            loc.load_existing_volumes()
        v = self.store.find_volume(vid)
        if v is None:
            return 500, {"error": "decoded volume failed to load"}
        self.store.queue_new_volume(v)
        return 200, {"dat_size": dat_size, "file_count": v.file_count(),
                     "seconds": seconds}

    def _h_ec_mount(self, h, path, q, body):
        vid = _q_req_uint(q, "volume")
        for loc in self.store.locations:
            loc.load_existing_volumes()
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return 404, {"error": f"no local shards for {vid}"}
        ev.refresh_shards()
        sids = ev.shard_ids()
        self.store.queue_new_ec_shards(vid, ev.collection, sum(1 << s for s in sids))
        return 200, {"shards": sids}

    def _h_ec_unmount(self, h, path, q, body):
        vid = _q_req_uint(q, "volume")
        ev = self.store.find_ec_volume(vid)
        for loc in self.store.locations:
            loc.unload_ec_volume(vid)
        if ev is not None and ev.shard_ids():
            self.store.queue_deleted_ec_shards(vid, ev.collection,
                                               sum(1 << s for s in ev.shard_ids()))
        return 200, {}

    def _h_ec_delete_shards(self, h, path, q, body):
        vid = _q_req_uint(q, "volume")
        shard_ids = _q_shards(q)
        base = self._find_base(vid)
        removed = []
        if base:
            for sid in shard_ids:
                try:
                    os.remove(base + shard_ext(sid))
                    removed.append(sid)
                except FileNotFoundError:
                    pass
        collection = ""
        for loc in self.store.locations:
            ev = loc.find_ec_volume(vid)
            if ev:
                collection = ev.collection
                for sid in shard_ids:
                    shard = ev.shards.pop(sid, None)
                    if shard:
                        shard.close()
        if removed:
            self.store.clear_corrupt(vid, shard_ids=removed)
            self.store.queue_deleted_ec_shards(vid, collection,
                                               sum(1 << s for s in removed))
        if base and not any(os.path.exists(base + shard_ext(s))
                            for s in range(TOTAL_SHARDS)):
            # the last shard is gone: the index and the deletion journal go
            # with it (VolumeEcShardsDelete)
            for ext in (".ecx", ".ecj"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
        return 200, {"removed": removed}

    # -- background CRC scrub (SWEED_SCRUB=1) --------------------------------
    def _scrub_loop(self) -> None:
        """Re-read needle records and verify their CRCs, at most
        SWEED_SCRUB_RATE needles a second a volume (default 32), and hash
        one EC shard a volume a round against the .vif sums. Findings go to
        the store's corrupt registry, which rides the heartbeat."""
        rate = max(1, tolerant_uint(os.environ.get("SWEED_SCRUB_RATE"), 32))
        cursors: dict[int, int] = {}  # vid -> next .dat offset to verify
        ec_cursors: dict[int, int] = {}  # vid -> next shard slot to hash
        while not self._stop.is_set():
            # a tiered volume's .dat is the backend's to keep: re-reading it
            # would GET the whole object from the tier every round (the JAX
            # server does)
            vols = [v for loc in self.store.locations for v in list(loc.volumes.values())
                    if not v.is_tiered()]
            for v in vols:
                if self._stop.is_set():
                    return
                try:
                    cursors[v.id] = self._scrub_volume_step(
                        v, cursors.get(v.id, 0), rate,
                        report=self.store.report_corrupt_needle)
                except Exception as e:  # noqa: BLE001 — the loop outlives one volume
                    # a compaction or unmount moved the ground under the
                    # cursor: restart this volume from the front
                    glog.warning("scrub vid %d reset: %s", v.id, e)
                    cursors[v.id] = 0
            ecs = [ev for loc in self.store.locations for ev in list(loc.ec_volumes.values())]
            for ev in ecs:
                if self._stop.is_set():
                    return
                try:
                    ec_cursors[ev.id] = self._scrub_ec_step(
                        ev, ec_cursors.get(ev.id, 0),
                        report=self.store.report_corrupt_shard)
                except Exception as e:  # noqa: BLE001 — the loop outlives one volume
                    glog.warning("scrub ec vid %d reset: %s", ev.id, e)
                    ec_cursors[ev.id] = 0
            self._stop.wait(1.0)

    @staticmethod
    def _scrub_ec_step(ev, cursor: int, report=None) -> int:
        """Hash at most one local shard of an EC volume against the sha256
        sums the encoder wrote into the .vif, and report a mismatch. Returns
        the next shard slot to try (0: wrapped)."""
        sums = encoder.load_volume_info(ev.base_file_name + ".vif").get("shard_sums")
        if not sums:
            return 0  # nothing to verify against
        sids = ev.shard_ids()
        for slot, sid in enumerate(sids):
            if slot < cursor or sid >= len(sums):
                continue
            digest = hashlib.sha256()
            total = 0
            with open(ev.base_file_name + shard_ext(sid), "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    digest.update(chunk)
                    total += len(chunk)
            SCRUB_COUNTERS["checked"].inc()
            SCRUB_COUNTERS["bytes"].inc(total)
            if digest.hexdigest() != sums[sid]:
                SCRUB_COUNTERS["errors"].inc()
                glog.warning("scrub: shard hash mismatch vid %d shard %d", ev.id, sid)
                if report is not None:
                    report(ev.id, sid)
            return slot + 1 if slot + 1 < len(sids) else 0
        return 0

    @staticmethod
    def _scrub_volume_step(v, offset: int, budget: int, report=None) -> int:
        """Verify up to ``budget`` needles of a volume from ``offset``;
        returns the cursor of the next step (0: wrapped)."""
        size = v.data_backend.size()
        offset = max(offset, v.super_block.block_size())
        checked = 0
        while checked < budget and offset + NEEDLE_HEADER_SIZE <= size:
            hdr = v.data_backend.read_at(offset, NEEDLE_HEADER_SIZE)
            if len(hdr) < NEEDLE_HEADER_SIZE:
                break
            _, nid, nsize = parse_needle_header(hdr)
            total = NEEDLE_HEADER_SIZE + needle_body_length(max(nsize, 0), v.version)
            if offset + total > size:
                break
            if nsize > 0:  # tombstones carry no payload to verify
                blob = v.data_backend.read_at(offset, total)
                try:
                    Needle.from_bytes(blob, nsize, v.version, verify_crc=True)
                except CrcError:
                    SCRUB_COUNTERS["errors"].inc()
                    glog.warning("scrub: CRC mismatch vid %d needle %d @%d",
                                 v.id, nid, offset)
                    if report is not None:
                        report(v.id, nid)
                SCRUB_COUNTERS["checked"].inc()
                SCRUB_COUNTERS["bytes"].inc(total)
                checked += 1
            offset += total
        if offset + NEEDLE_HEADER_SIZE > size:
            if size > v.super_block.block_size():  # an empty volume is no round
                SCRUB_COUNTERS["rounds"].inc()
            return 0
        return offset

    def _join_scrub(self) -> None:
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=5.0)
            self._scrub_thread = None

    # -- heartbeat loop (volume_grpc_client_to_master.go:50) -----------------
    def _send_beat(self, hb: dict) -> None:
        hb["data_center"] = self.data_center
        hb["rack"] = self.rack
        hb["max_volume_count"] = self.max_volume_count
        if self.mesh_info is not None:
            hb["mesh"] = self.mesh_info
        ack = http_json("POST", f"http://{self.master_url}/cluster/heartbeat", hb,
                        timeout=10)
        # follow the leader the master announces
        leader = ack.get("leader")
        if leader and leader != self.master_url:
            glog.info("following new master leader %s", leader)
            self.master_url = leader

    def _heartbeat_once(self) -> None:
        # drain before collecting: a delta queued during the collection then
        # stays queued and goes as its own beat; the other order would lose
        # the delta of a volume created after the snapshot
        self.store.drain_deltas()
        hb = self.store.collect_heartbeat()
        hb["ec_shards"] = self.store.collect_ec_heartbeat()["ec_shards"]
        # the master scales this node's liveness timeout to the pulse
        hb["pulse_seconds"] = self.pulse_seconds
        self._send_beat(hb)

    def _delta_beat_once(self) -> None:
        """Instant delta beat: only the queued new/deleted volume and EC
        shard messages (volume_grpc_client_to_master.go:155-197)."""
        deltas = self.store.drain_deltas()
        if not deltas:
            return
        hb = {"ip": self.host, "port": self.port, "public_url": self.store.public_url}
        hb.update(deltas)
        self._send_beat(hb)

    def _hb_loop(self) -> None:
        next_full = time.monotonic() + self.pulse_seconds
        while not self._stop.is_set():
            remaining = max(0.0, next_full - time.monotonic())
            fired = self.store.delta_event.wait(min(remaining, 2.0))
            if self._stop.is_set():
                break
            try:
                if fired:
                    self._delta_beat_once()
                elif time.monotonic() >= next_full:
                    self._heartbeat_once()
                    next_full = time.monotonic() + self.pulse_seconds
                else:
                    # idle liveness probe: a long pulse must not hide a
                    # master failover for up to pulse_seconds
                    r = http_json("GET", f"http://{self.master_url}/cluster/ping",
                                  timeout=2.0)
                    if not r.get("ok"):
                        raise RuntimeError(f"ping: {r}")
            except Exception as e:  # noqa: BLE001 — the loop must outlive the master
                # this master is unreachable: rotate to the next seed and
                # re-register soon with a full beat
                glog.V(1).info("heartbeat to %s failed (%s); rotating",
                               self.master_url, e)
                self._rotate_master()
                next_full = time.monotonic() + min(1.0, self.pulse_seconds)

    def _rotate_master(self) -> None:
        if len(self.master_seeds) <= 1:
            return
        try:
            i = self.master_seeds.index(self.master_url)
        except ValueError:
            i = -1
        self.master_url = self.master_seeds[(i + 1) % len(self.master_seeds)]

    def _init_mesh(self) -> None:
        """SWEED_MESH=1: join the fleet's ``torch.distributed`` mesh before
        the first heartbeat. Coordinates come from the environment:

            SWEED_MESH_COORDINATOR    host:port of rank 0's rendezvous (empty:
                                      this node is a 1-process mesh, and no
                                      process group is made)
            SWEED_MESH_PROCESS_ID     this server's rank
            SWEED_MESH_NUM_PROCESSES  the fleet's size

        The group's backend is NCCL, or gloo under ``-ec.backend cpu``; the
        rendezvous waits at most MESH_INIT_TIMEOUT_S. A failure is
        survivable: the server serves, reports initialized=false, and the
        fleet scheduler stops preferring it for mesh work."""
        coordinator = os.environ.get("SWEED_MESH_COORDINATOR", "")
        num = tolerant_uint(os.environ.get("SWEED_MESH_NUM_PROCESSES"), 1) or 1
        pid = tolerant_uint(os.environ.get("SWEED_MESH_PROCESS_ID"), 0) or 0
        self.mesh_info = {
            "coordinator": coordinator,
            "process_id": pid,
            "num_processes": num,
            "initialized": False,
        }
        try:
            if coordinator and num > 1:
                from ..ec.sharded import init_mesh

                backend = "gloo" if self.store.ec_backend == "cpu" else "nccl"
                init_mesh(coordinator, num, pid, backend, timeout=MESH_INIT_TIMEOUT_S)
                self._mesh_group = True
                self.mesh_info["backend"] = backend
            import torch

            self.mesh_info["local_devices"] = (
                1 if self.store.ec_backend == "cpu" else torch.cuda.device_count())
            self.mesh_info["initialized"] = True
            glog.info("mesh member up: process %d/%d (coordinator %s)",
                      pid, num, coordinator or "<self>")
        except Exception as e:  # noqa: BLE001 — degraded, not dead
            glog.warning("torch.distributed init failed: %s", e)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "VolumeServer":
        if os.environ.get("SWEED_MESH") == "1" and self.mesh_info is None:
            self._init_mesh()
        vs = self

        class Handler(JsonHandler):
            trace_service = "volume"
            routes = [
                ("GET", "/debug/traces", trace.h_debug_traces),
                ("POST", "/admin/assign_volume", vs._h_assign_volume),
                ("POST", "/admin/delete_volume", vs._h_delete_volume),
                ("POST", "/_batch_delete", vs._h_batch_delete),
                ("POST", "/_query", vs._h_query),
                ("POST", "/admin/readonly", vs._h_readonly),
                ("POST", "/admin/writable", vs._h_writable),
                ("POST", "/admin/volume_unmount", vs._h_volume_unmount),
                ("POST", "/admin/volume_mount", vs._h_volume_mount),
                ("GET", "/admin/vacuum_check", vs._h_vacuum_check),
                ("POST", "/admin/vacuum", vs._h_vacuum),
                ("POST", "/admin/volume_copy", vs._h_volume_copy),
                ("GET", "/admin/tail", vs._h_tail),
                ("GET", "/admin/volume_status", vs._h_volume_status),
                ("GET", "/admin/incremental_copy", vs._h_incremental_copy),
                ("POST", "/admin/tier_upload", vs._h_tier_upload),
                ("POST", "/admin/tier_download", vs._h_tier_download),
                ("POST", "/admin/volume_configure_replication",
                 vs._h_volume_configure_replication),
                ("POST", "/admin/server_leave", vs._h_server_leave),
                ("POST", "/admin/ec/generate", vs._h_ec_generate),
                ("POST", "/admin/ec/rebuild", vs._h_ec_rebuild),
                ("POST", "/admin/ec/copy", vs._h_ec_copy),
                ("GET", "/admin/ec/shard_read", vs._h_ec_shard_read),
                ("POST", "/admin/ec/to_volume", vs._h_ec_to_volume),
                ("POST", "/admin/ec/mount", vs._h_ec_mount),
                ("POST", "/admin/ec/unmount", vs._h_ec_unmount),
                ("POST", "/admin/ec/delete_shards", vs._h_ec_delete_shards),
                ("GET", "/admin/file", vs._h_file),
                ("GET", "/admin/needle_ids", vs._h_needle_ids),
                ("GET", "/admin/needle_info", vs._h_needle_info),
                ("POST", "/admin/ncache", vs._h_ncache),
                ("GET", "/status", vs._h_status),
                ("GET", "/ui", vs._h_ui),
                ("GET", "/metrics", vs._h_metrics),
                ("GET", "/", vs._h_get),
                ("HEAD", "/", vs._h_get),
                ("POST", "/", vs._h_post),
                ("PUT", "/", vs._h_post),
                ("DELETE", "/", vs._h_delete),
            ]
            # the hot read path on the aio core's loop; every edge falls
            # back to the bridged _h_get above
            native_routes = [
                ("GET", "/", vs._h_get_native),
                ("HEAD", "/", vs._h_get_native),
            ]

        self._start_turbo(Handler)
        if self.turbo is None:
            self._srv = start_server(Handler, self.host, self.port)
        glog.info("volume server up on %s:%d (%d volumes, ec backend %s, turbo %s) "
                  "-> master %s", self.host, self.port,
                  sum(len(loc.volumes) for loc in self.store.locations),
                  self.store.ec_backend, "on" if self.turbo is not None else "off",
                  self.master_url)
        try:
            self._heartbeat_once()
        except Exception:  # noqa: BLE001 — the beat loop retries
            glog.warning("initial heartbeat to %s failed", self.master_url)
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True,
                                           name=f"heartbeat-{self.port}")
        self._hb_thread.start()
        if os.environ.get("SWEED_SCRUB") == "1":
            self._scrub_thread = threading.Thread(target=self._scrub_loop, daemon=True,
                                                  name=f"scrub-{self.port}")
            self._scrub_thread.start()
        return self

    def _start_turbo(self, handler_cls) -> None:
        """The native engine takes the public port and this daemon moves to
        a loopback port that the engine proxies every other request to, as
        the JAX package's server does by default. Off under SWEED_TURBO=0 or
        with an IP whitelist (which stays in Python). An engine that cannot
        be built or bound leaves the daemon on the public port, with the
        reason in ``/status`` and the log."""
        from ..storage.turbo import TurboEngine, load, load_error

        if os.environ.get("SWEED_TURBO", "1") == "0":
            self.turbo_reason = "SWEED_TURBO=0"
            return
        if not self.guard.allow_all:
            self.turbo_reason = "an IP whitelist is served by Python"
            return
        if load() is None:
            self.turbo_reason = f"engine unavailable: {load_error()}"
            return
        internal = start_server(handler_cls, TURBO_BACKEND_HOST, 0)
        try:
            iport = internal.server_address[1]
            self.turbo = TurboEngine(self.host, self.port, TURBO_BACKEND_HOST, iport)
            if self.jwt_signing_key or self.jwt_read_key:
                # fid JWTs are verified in the engine (HMAC-SHA256), so auth
                # keeps the fast path
                self.turbo.set_jwt_keys(self.jwt_signing_key, self.jwt_read_key)
            self._srv = internal
            self.store.turbo_engine = self.turbo
            self.store.attach_turbo_all()
        except Exception as e:  # noqa: BLE001 — served from Python, said in /status
            glog.warning("turbo engine disabled: %s", e)
            self.turbo_reason = f"{type(e).__name__}: {e}"
            if self.turbo is not None:
                self.turbo.stop()
                self.turbo = None
            self.store.turbo_engine = None
            self._srv = None
            internal.shutdown()
            internal.server_close()
            return
        self.turbo_reason = ""
        glog.info("turbo data plane on %s:%d (%d workers) -> python %s:%d",
                  self.host, self.port, self.turbo.threads, TURBO_BACKEND_HOST, iport)

    def stop(self) -> None:
        self._stop.set()
        self.store.delta_event.set()  # wake the heartbeat loop so it exits
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
        self._join_scrub()
        # the public port first (the engine finishes its in-flight proxies
        # against the still-live loopback server), then the loopback server,
        # then the store (each volume's detach is a no-op against the
        # stopped engine)
        if self.turbo is not None:
            self.turbo.stop()
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        self.store.close()
        self.store.turbo_engine = None
        self.turbo = None
        if self._mesh_group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self._mesh_group = False
        glog.info("volume server %s:%d stopped", self.host, self.port)
