"""Byte-rate throttling of background copies, and per-tenant QoS.

``WriteThrottler`` is the reference's `weed/util/throttler.go` design:
count bytes in ~100 ms windows; when a window exceeds its share of the
bytes/s budget, sleep in proportion to the overage. It paces compaction
(`volume_vacuum.go` compactionBytePerSecond) so maintenance IO does not
starve the data plane. An instance is not thread-safe: each compaction
makes its own.

``TokenBucket`` and ``TenantGovernor`` are the serving tier's admission
(the JAX package's): every request is classified to a tenant
(``classify_tenant``: ``X-Sweed-Internal`` hops bypass, then
``X-Sweed-Tenant``, the S3 access key, the remote /24) and admitted
through that tenant's token bucket. The buckets share one total rate
(``SWEED_QOS_RPS``; 0, the default, turns the governor off) split
weighted-fair (``SWEED_QOS_WEIGHTS``) across the tenants active in the
last few seconds. A request over its share is paced up to
``SWEED_QOS_MAX_DELAY_MS``, then shed with 503 + ``Retry-After``. Both
serving cores admit through the one process-wide ``GOVERNOR``
(``server/http_util.py``, ``server/aio.py``).
"""

from __future__ import annotations

import os
import time
from .locks import make_lock
from .racecheck import instrument



class WriteThrottler:
    def __init__(self, bytes_per_second: int = 0):
        self.bytes_per_second = bytes_per_second
        self._counter = 0
        self._window_start = time.monotonic()

    def maybe_slowdown(self, delta: int) -> None:
        if self.bytes_per_second <= 0:
            return
        self._counter += delta
        now = time.monotonic()
        elapsed = now - self._window_start
        # settle the window once 100 ms have passed or its byte budget is
        # spent (the latter paces bursts shorter than a window)
        if elapsed > 0.1 or self._counter >= self.bytes_per_second // 10:
            expected = self._counter / self.bytes_per_second
            if expected > elapsed:
                time.sleep(expected - elapsed)
            self._counter = 0
            self._window_start = time.monotonic()


# -- per-tenant QoS ------------------------------------------------------------

#: tenant key for intra-cluster traffic (bypasses the governor)
INTERNAL_TENANT = "internal"
#: header internal transports stamp on every hop
INTERNAL_HEADER = "X-Sweed-Internal"
#: explicit tenant override header (tests, trusted proxies)
TENANT_HEADER = "X-Sweed-Tenant"


def classify_tenant(header_get, remote_addr: str) -> str:
    """Map a request to its tenant key, cheapest signal first.

    ``header_get`` is any case-insensitive ``get(name, default)`` callable
    (http.client message, or the native path's header view). Priority:

    1. ``X-Sweed-Internal`` — intra-cluster hop, never throttled;
    2. ``X-Sweed-Tenant`` — explicit assignment;
    3. the S3 access key out of the Authorization header (SigV4
       ``Credential=AK/...`` or SigV2 ``AWS AK:sig``) — the natural S3
       tenant boundary;
    4. the remote /24 address class — anonymous HTTP traffic aggregates
       per source network, not per socket, so one client opening 10k
       connections is still ONE tenant.
    """
    if header_get(INTERNAL_HEADER, ""):
        return INTERNAL_TENANT
    t = header_get(TENANT_HEADER, "")
    if t:
        return "hdr:" + t[:64]
    auth = header_get("Authorization", "")
    if auth.startswith("AWS4-HMAC-SHA256"):
        _, _, rest = auth.partition("Credential=")
        ak = rest.split("/", 1)[0].strip()
        if ak:
            return "ak:" + ak[:64]
    elif auth.startswith("AWS "):
        ak = auth[4:].split(":", 1)[0].strip()
        if ak:
            return "ak:" + ak[:64]
    if ":" in remote_addr:  # IPv6: aggregate the /48-ish prefix
        return "ip:" + ":".join(remote_addr.split(":")[:3])
    return "ip:" + ".".join(remote_addr.split(".")[:3])


@instrument
class TokenBucket:
    """Monotonic-clock token bucket; thread-safe (shared by the threads
    core's workers and the aio loop).

    ``reserve(n, max_wait)`` settles in one call: 0.0 when tokens were
    available, a positive pacing delay (the tokens are taken as DEBT so
    concurrent reservers queue behind each other, not on top), or None
    when the wait would exceed ``max_wait`` — the caller sheds."""

    def __init__(self, rate: float, burst: float):
        self._mu = make_lock("TokenBucket._mu")
        self.rate = max(rate, 1e-3)
        self.burst = max(burst, 1.0)
        self._tokens = self.burst
        self._t = time.monotonic()

    def set_rate(self, rate: float, burst: float) -> None:
        with self._mu:
            self.rate = max(rate, 1e-3)
            self.burst = max(burst, 1.0)
            self._tokens = min(self._tokens, self.burst)

    def reserve(self, n: float = 1.0, max_wait: float = 0.0):
        with self._mu:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            wait = (n - self._tokens) / self.rate
            if wait <= max_wait:
                self._tokens -= n  # debt: successors pace behind this one
                return wait
            return None


@instrument
class _Tenant:
    __slots__ = ("bucket", "weight", "last_seen",
                 "admitted", "delayed", "shed")

    def __init__(self, rate: float, weight: float):
        self.bucket = TokenBucket(rate, max(rate, 4.0))
        self.weight = weight
        self.last_seen = time.monotonic()
        self.admitted = 0
        self.delayed = 0
        self.shed = 0


@instrument
class TenantGovernor:
    """Weighted-fair request admission across tenants.

    The configured total rate (``SWEED_QOS_RPS``; 0 = governor off) is
    divided among ACTIVE tenants (seen within ``ACTIVE_WINDOW``) in
    proportion to their weights (``SWEED_QOS_WEIGHTS="ak:alice=4,*=1"``;
    ``*`` sets the default). Shares are recomputed at most every
    ``RECOMPUTE_INTERVAL`` so the hot path stays one bucket reservation.
    Tenant cardinality is bounded: past ``MAX_TENANTS`` the
    longest-idle tenant is evicted (its counters fold into the evicted
    totals so /metrics stays truthful)."""

    ACTIVE_WINDOW = 5.0
    RECOMPUTE_INTERVAL = 0.5
    MAX_TENANTS = 1024

    def __init__(self):
        self._mu = make_lock("TenantGovernor._mu")
        self._tenants: dict[str, _Tenant] = {}
        self._next_recompute = 0.0
        self._evicted_shed = 0

    # env knobs are read per recompute so tests can flip them live
    @staticmethod
    def total_rate() -> float:
        raw = os.environ.get("SWEED_QOS_RPS", "0").strip()
        if not (raw.isascii() and raw.isdigit()):
            return 0.0
        return float(int(raw))

    @staticmethod
    def max_delay() -> float:
        raw = os.environ.get("SWEED_QOS_MAX_DELAY_MS", "250").strip()
        if not (raw.isascii() and raw.isdigit()):
            return 0.25
        return int(raw) / 1000.0

    @staticmethod
    def _weights() -> dict[str, float]:
        out: dict[str, float] = {}
        for part in os.environ.get("SWEED_QOS_WEIGHTS", "").split(","):
            name, _, w = part.strip().rpartition("=")
            if not name or not w:
                continue
            if w.isascii() and w.isdigit() and int(w) > 0:
                out[name] = float(int(w))
        return out

    def enabled(self) -> bool:
        return self.total_rate() > 0

    def _recompute_locked(self, now: float) -> None:
        total = self.total_rate()
        if total <= 0:
            return
        weights = self._weights()
        default_w = weights.get("*", 1.0)
        active = [
            t for t in self._tenants.values()
            if now - t.last_seen <= self.ACTIVE_WINDOW
        ]
        wsum = 0.0
        for key, t in self._tenants.items():
            t.weight = weights.get(key, default_w)
            if now - t.last_seen <= self.ACTIVE_WINDOW:
                wsum += t.weight
        if wsum <= 0:
            return
        for t in active:
            share = total * (t.weight / wsum)
            # a one-second burst allowance keeps short spikes un-paced
            # without letting a tenant bank idle seconds into a storm
            t.bucket.set_rate(share, max(share, 4.0))
        self._next_recompute = now + self.RECOMPUTE_INTERVAL

    def admit(self, tenant: str) -> tuple[str, float]:
        """→ ("ok", 0) | ("delay", seconds) | ("shed", 0).

        "delay" means the caller owes a pacing sleep (time.sleep on a
        worker thread, asyncio.sleep on the loop) and is then admitted.
        """
        if tenant == INTERNAL_TENANT or not self.enabled():
            return "ok", 0.0
        now = time.monotonic()
        with self._mu:
            t = self._tenants.get(tenant)
            if t is None:
                total = self.total_rate()
                t = self._tenants[tenant] = _Tenant(total, 1.0)
                while len(self._tenants) > self.MAX_TENANTS:
                    oldest = min(
                        self._tenants, key=lambda k: self._tenants[k].last_seen
                    )
                    self._evicted_shed += self._tenants[oldest].shed
                    del self._tenants[oldest]
                self._next_recompute = 0.0  # new tenant → reslice now
            t.last_seen = now
            if now >= self._next_recompute:
                self._recompute_locked(now)
            bucket = t.bucket
        wait = bucket.reserve(1.0, self.max_delay())
        with self._mu:
            if wait is None:
                t.shed += 1
                return "shed", 0.0
            if wait > 0:
                t.delayed += 1
                return "delay", wait
            t.admitted += 1
            return "ok", 0.0

    def snapshot(self) -> dict:
        """Per-tenant counters for /metrics and /_status."""
        with self._mu:
            tenants = {
                key: {
                    "admitted": t.admitted,
                    "delayed": t.delayed,
                    "shed": t.shed,
                    "rate": round(t.bucket.rate, 2),
                    "weight": t.weight,
                }
                for key, t in sorted(self._tenants.items())
            }
            return {
                "enabled": self.enabled(),
                "total_rate": self.total_rate(),
                "tenants": tenants,
                "shed_total": self._evicted_shed
                + sum(t["shed"] for t in tenants.values()),
            }

    def reset(self) -> None:
        """Test hook: forget every tenant and counter."""
        with self._mu:
            self._tenants.clear()
            self._next_recompute = 0.0
            self._evicted_shed = 0


#: process-wide governor — every serving core admits through this one
#: instance so weighted-fair shares see ALL tenants, whichever port they
#: arrived on
GOVERNOR = TenantGovernor()
