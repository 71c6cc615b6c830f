"""Lease-granted fid ranges: assigns that scale with the number of clients.

Every write otherwise serializes on the master's ``/dir/assign``: one
sequencer bump per round trip. As the reference's batch-allocating
sequencers do (``weed/sequence``), the master leases a whole needle-key
range to a client (a filer in the JAX package) in one round trip, and the
client mints fids locally until the range runs dry or the lease expires.

Crash safety is the point. A leased range is indistinguishable from used
ids (the client may have minted any of them before the master died), so a
grant is durable before the reply leaves the master: an fsync'd JSONL
journal, replayed at start into ``sequencer.set_max(end of every granted
range)``. Across any restart no fid is issued twice; the unused tail of a
range is a gap in the needle ids, harmless. The journal is the JAX
package's format, and either package replays the other's.

Expiry is bookkeeping, not reclamation: an expired lease's unused keys are
never issued again (the journal burns them); it keeps the lease table
bounded.

Client side, :class:`LeasedFidSource` wraps the grant RPC: it mints
``FileId(vid, start+i, cookie)`` locally, leases again when dry, and falls
back to the caller's per-request assign on any error, and on a cluster that
enforces JWTs when the client holds no signing key (the master's token
covers only the base fid).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

from .. import operation
from ..storage.file_id import FileId
from ..util import glog
from ..util.locks import make_lock
from ..util.racecheck import instrument


def lease_seconds() -> float:
    raw = os.environ.get("SWEED_FID_LEASE_S", "30").strip()
    try:
        v = float(raw)
    except ValueError:
        return 30.0
    return v if (v == v and v > 0) else 30.0


def lease_count() -> int:
    """Keys per grant. Modest by default: a dying filer burns at most
    this many ids, and one lease pins writes to one volume for at most
    this many needles before the next grant re-randomizes placement."""
    raw = os.environ.get("SWEED_FID_LEASE_COUNT", "128").strip()
    if not (raw.isascii() and raw.isdigit()) or int(raw) < 1:
        return 128
    return int(raw)


@instrument
class FidLeaseManager:
    """Master-side lease table + crash-safe grant/renew/expiry journal.

    The caller (master_server) reserves the key range through its normal
    assign path — volume pick + sequencer bump — then registers the
    range here; ``register`` journals it durably and only then may the
    response go on the wire."""

    def __init__(self, journal_path: Optional[str] = None):
        self._lock = make_lock("FidLeaseManager._lock")
        self._path = journal_path
        self._fh = None
        self._leases: dict[str, dict] = {}
        self._seq = 0
        self._granted = 0
        self._renewed = 0
        self._expired = 0
        self._replayed_max = 0

    # -- journal -------------------------------------------------------------
    def _append_locked(self, rec: dict) -> None:
        """Caller holds ``self._lock`` (the _locked convention)."""
        if not self._path:
            return
        if self._fh is None:
            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            self._fh = open(self._path, "a", encoding="utf-8")
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._fh.flush()
        # sweedlint: ok blocking-under-lock grant durability IS the serialization point: the journal append must be ordered with the table mutation, and a lease RPC happens once per SWEED_FID_LEASE_COUNT fids
        os.fsync(self._fh.fileno())

    def replay(self, set_max: Callable[[int], None]) -> int:
        """Restart path: push every journaled grant's range end into the
        sequencer BEFORE it issues anything. Torn last lines (crash mid-
        append) are skipped — a torn grant never answered its RPC, so no
        filer holds that range. Returns the highest key protected."""
        if not self._path or not os.path.exists(self._path):
            return 0
        high = 0
        with open(self._path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail; grant never acked
                if rec.get("op") == "grant":
                    end = int(rec.get("key", 0)) + int(rec.get("count", 0))
                    if end > high:
                        high = end
        if high:
            set_max(high)
            with self._lock:
                self._replayed_max = high
        return high

    # -- lease table ---------------------------------------------------------
    def register(self, client: str, vid: int, key: int, count: int,
                 ttl_s: Optional[float] = None) -> dict:
        """Durably record a reserved range as leased to ``client``.
        Returns {lease_id, expires}. MUST complete before the grant
        response is sent — the journal is what makes a restarted master
        honor ranges in flight."""
        ttl = ttl_s if ttl_s else lease_seconds()
        with self._lock:
            self._seq += 1
            lease_id = f"L{self._seq}-{key}"
            expires = time.time() + ttl
            rec = {
                "op": "grant", "lease_id": lease_id, "client": client,
                "vid": vid, "key": key, "count": count, "expires": expires,
            }
            self._append_locked(rec)
            self._leases[lease_id] = rec
            self._granted += 1
        return {"lease_id": lease_id, "expires": expires}

    def renew(self, lease_id: str, ttl_s: Optional[float] = None
              ) -> Optional[float]:
        """Extend a live lease; None for unknown/expired ids (the filer
        then grants afresh — renewal is an optimization, never required
        for correctness)."""
        ttl = ttl_s if ttl_s else lease_seconds()
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease["expires"] <= time.time():
                return None
            lease["expires"] = time.time() + ttl
            self._append_locked({"op": "renew", "lease_id": lease_id,
                          "expires": lease["expires"]})
            self._renewed += 1
            return lease["expires"]

    def expire_stale(self) -> int:
        """Drop expired leases from the live table (their ranges stay
        burned — the grant journal already protects them)."""
        now = time.time()
        with self._lock:
            stale = [lid for lid, rec in self._leases.items()
                     if rec["expires"] <= now]
            for lid in stale:
                del self._leases[lid]
                self._append_locked({"op": "expire", "lease_id": lid})
            self._expired += len(stale)
        return len(stale)

    def stats(self) -> dict:
        with self._lock:
            now = time.time()
            return {
                "live": sum(1 for r in self._leases.values()
                            if r["expires"] > now),
                "granted": self._granted,
                "renewed": self._renewed,
                "expired": self._expired,
                "replayed_max_key": self._replayed_max,
            }

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class LeasedFidSource:
    """Filer-side minting over granted ranges, one range per
    (collection, replication, ttl) key.

    ``grant_fn(collection, replication, ttl, count)`` performs the lease
    RPC and returns the master's response dict; ``fallback_fn`` is the
    per-request assign path used when leasing can't serve (RPC failure,
    auth without a local signing key, disabled). ``sign_fn(fid)`` mints
    the per-fid JWT on auth clusters ('' when unsigned)."""

    def __init__(self, grant_fn, fallback_fn,
                 sign_fn: Optional[Callable[[str], str]] = None):
        self._grant = grant_fn
        self._fallback = fallback_fn
        self._sign = sign_fn
        self._lock = make_lock("LeasedFidSource._lock")
        self._ranges: dict[tuple, dict] = {}
        self.minted = 0
        self.leases = 0
        self.fallbacks = 0

    @staticmethod
    def enabled() -> bool:
        return os.environ.get("SWEED_FID_LEASE", "1").strip() != "0"

    def assign(self, collection: str, replication: str, ttl: str):
        if not self.enabled():
            return self._fallback(collection, replication, ttl)
        key = (collection, replication, ttl)
        with self._lock:
            rng = self._ranges.get(key)
            if (rng is None or rng["next"] >= rng["end"]
                    or rng["expires"] <= time.time()):
                rng = self._lease_locked(key)
                if rng is None:
                    self.fallbacks += 1
                else:
                    self._ranges[key] = rng
            if rng is not None:
                i = rng["next"]
                rng["next"] += 1
                fid = str(FileId(rng["vid"], i, rng["cookie"]))
                auth = ""
                if rng["auth"]:
                    auth = (rng["base_auth"] if i == rng["base_key"]
                            else self._sign(fid))
                self.minted += 1
                return operation.Assignment(
                    fid=fid, url=rng["url"], public_url=rng["public_url"],
                    count=1, auth=auth,
                )
        # lease path unavailable: per-request assign outside the lock
        return self._fallback(collection, replication, ttl)

    def _lease_locked(self, key: tuple) -> Optional[dict]:
        """Caller holds ``self._lock`` (the _locked convention)."""
        collection, replication, ttl = key
        try:
            r = self._grant(collection, replication, ttl, lease_count())
        except Exception as e:  # lease is an optimization; any failure falls back to per-request assigns
            glog.V(1).info("fid lease grant failed (%s); falling back", e)
            return None
        if not r or r.get("error"):
            return None
        auth = r.get("auth", "")
        if auth and self._sign is None:
            # auth-enforced cluster, no local signing key: minted fids
            # beyond the base would be unusable — lease can't serve
            return None
        try:
            base = FileId.parse(r["fid"])
        except (KeyError, ValueError):
            return None
        count = int(r.get("count", 1))
        self.leases += 1
        return {
            "vid": base.volume_id,
            "base_key": base.key,
            "next": base.key,
            "end": base.key + max(1, count),
            "cookie": base.cookie,
            "url": r["url"],
            "public_url": r.get("publicUrl", r["url"]),
            "auth": auth,
            "base_auth": auth,
            "expires": float(r.get("expires", time.time() + lease_seconds())),
            "lease_id": r.get("lease_id", ""),
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "minted": self.minted,
                "leases": self.leases,
                "fallbacks": self.fallbacks,
                "active_ranges": len(self._ranges),
            }
