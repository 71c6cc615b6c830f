"""Metrics registry with Prometheus text exposition.

The port of the JAX package's ``stats/metrics.py`` (after the reference's
`weed/stats/metrics.go`): labelled ``Counter`` and
``Gauge`` (a gauge may read a function at exposition time), the
``Registry`` that ``/metrics`` of the volume server and the master expose
in the Prometheus text format, and ``default_registry`` with the gauges and
counters under the reference's names:

- ``sweed_serving_*``: the serving core (``server/http_util.SERVING``);
- ``sweed_heat_*``: the volumes' heat (``stats/heat.py``);
- ``sweed_ncache_*``: the hot-needle cache (``util/needle_cache.py``);
- ``sweed_fleet_*``: the master's EC scheduler (``cluster/fleet.py``);
- ``sweed_query_*``: the scan engine (``query/scan.py``);
- ``sweed_scrub_*``: the background scrub;
- ``sweed_qos_*``: the tenant governor (``util/throttler.GOVERNOR``), a
  per-tenant latency histogram and decision counter;
- ``sweed_deadline_*``: deadline events (``util/deadline.counts``);
- ``sweed_sync_*``: filer.sync's directions (``replication/controller.
  sync_stats``);
- ``sweed_lifecycle_*``: the master's autopilot (``cluster/lifecycle.py``,
  which also owns the ``lifecycle_cycle_seconds`` and
  ``lifecycle_action_seconds`` histograms). The election and the fid leases
  register no family, as in the JAX package: ``/dir/status`` reports them.

Counters and gauges are bumped and read from request and background
threads, so each takes its own lock. ``MetricsPusher`` pushes a registry
to a Prometheus push gateway (``-metrics.address``). Not ported: the gauges
of features the port has not got yet (the lock sanitizer, hedged reads),
and the host probes (``disk_status``, ``memory_status``), which
nothing in the JAX package's daemons prints.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..util import glog
from ..util.locks import make_lock
from ..util.racecheck import instrument
from .histogram import Histogram, _fmt_labels


@instrument
class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = make_lock("Counter._lock")

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum across all label sets."""
        with self._lock:
            return sum(self._values.values())

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


@instrument
class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._fns: dict[tuple, Callable[[], float]] = {}
        self._lock = make_lock("Gauge._lock")

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = float(value)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        """A gauge read from ``fn`` at exposition time."""
        with self._lock:
            self._fns[tuple(sorted(labels.items()))] = fn

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            fn = self._fns.get(key)
            if fn is None:
                return self._values.get(key, 0.0)
        return float(fn())

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = dict(self._values)
            fns = dict(self._fns)
        for key, fn in fns.items():
            try:
                items[key] = float(fn())
            except Exception as e:  # noqa: BLE001 — one probe must not break /metrics
                glog.V(2).info("gauge %s callback failed: %s", self.name, e)
        for key, v in sorted(items.items()):
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


class Registry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = make_lock("Registry._lock")

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", buckets=None) -> Histogram:
        return self._get_or_make(name, lambda: Histogram(name, help_, buckets))

    def register(self, metric):
        """Add an existing metric object (a module-level histogram); the
        first one registered under a name wins."""
        return self._get_or_make(metric.name, lambda: metric)

    def _get_or_make(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def expose(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


default_registry = Registry()


def register_lock_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the OrderedLock sanitizer's counters (util/locks.py):
    total acquisitions, contended acquires, deepest held-while-acquiring
    nesting, and the observed order-graph edge count.  All zero unless
    the process runs with SWEED_LOCK_CHECK=1."""
    from ..util.locks import lock_stats

    reg = registry if registry is not None else default_registry
    reg.gauge(
        "sweed_lock_acquisitions_total",
        "instrumented lock acquisitions (SWEED_LOCK_CHECK=1)",
    ).set_function(lambda: lock_stats()["acquisitions"])
    reg.gauge(
        "sweed_lock_contended_total",
        "acquires that found the lock held",
    ).set_function(lambda: lock_stats()["contended"])
    reg.gauge(
        "sweed_lock_max_held_depth",
        "deepest held-while-acquiring nesting observed",
    ).set_function(lambda: lock_stats()["max_held_depth"])
    reg.gauge(
        "sweed_lock_order_edges",
        "distinct observed lock-order edges",
    ).set_function(lambda: len(lock_stats()["edges"]))


register_lock_metrics()


class MetricsPusher:
    """Pushes a registry's exposition to a Prometheus push gateway every
    ``interval_seconds`` (stats/metrics.go:69 startPushingMetric, behind
    ``-metrics.address``); the ``/metrics`` pull page serves either way."""

    def __init__(self, registry: Registry, gateway_url: str, job: str,
                 instance: str = "", interval_seconds: float = 15.0):
        self.registry = registry
        url = gateway_url.rstrip("/")
        if not url.startswith("http"):
            url = "http://" + url
        self.url = f"{url}/metrics/job/{job}"
        if instance:
            self.url += f"/instance/{instance}"
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def push_once(self) -> bool:
        from ..server.http_util import http_bytes  # stats must not import the server at import

        try:
            status, _ = http_bytes("POST", self.url, body=self.registry.expose().encode(),
                                   headers={"Content-Type": "text/plain"}, timeout=10)
            return status < 300
        except Exception:  # noqa: BLE001 — a gateway down: keep trying, pull still works
            return False

    def start(self) -> "MetricsPusher":
        def loop():
            while not self._stop.wait(self.interval):
                self.push_once()

        self._thread = threading.Thread(target=loop, daemon=True, name="metrics-push")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def _gauges(reg: Registry, snap: Callable[[str], float], specs) -> None:
    for name, help_, key in specs:
        reg.gauge(name, help_).set_function(lambda key=key: snap(key))


def serving_stats() -> dict:
    """Snapshot of the serving-core counters for /_status."""
    from ..server.http_util import SERVING

    return SERVING.snapshot()


def register_serving_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the serving core (``server/http_util.SERVING``)."""

    def snap(key):
        from ..server.http_util import SERVING  # stats must not import the server at import

        return SERVING.snapshot().get(key, 0)

    _gauges(registry or default_registry, snap, (
        ("sweed_serving_inflight", "connections currently inside live HTTP servers",
         "inflight"),
        ("sweed_serving_admission_rejected_total",
         "connections shed with 503 + Retry-After at the watermark", "admission_rejected"),
        ("sweed_serving_keepalive_shed_total",
         "keep-alive replies downgraded to Connection: close while overloaded",
         "keepalive_shed"),
        ("sweed_serving_loop_lag_ms", "event-loop scheduling lag, last sample (aio mode)",
         "loop_lag_ms"),
        ("sweed_serving_loop_lag_max_ms",
         "worst event-loop scheduling lag observed (aio mode)", "loop_lag_max_ms"),
        ("sweed_serving_assign_batches_total", "coalesced master assign RPC rounds",
         "assign_batches"),
        ("sweed_serving_assign_fids_total",
         "fids handed out through coalesced assign rounds", "assign_fids"),
        ("sweed_serving_assign_max_batch", "largest coalesced assign batch observed",
         "assign_max_batch"),
        ("sweed_serving_request_p99_ms",
         "p99 request service time over the recent ring (feeds Retry-After)",
         "request_p99_ms"),
        ("sweed_serving_reaped_idle_total",
         "connections reaped for exceeding the idle timeout (slow-loris)", "reaped_idle"),
        ("sweed_serving_reaped_deadline_total",
         "connections reaped for exceeding the handler deadline", "reaped_deadline"),
        ("sweed_serving_native_hits_total",
         "requests served by native-async fast-path handlers (no bridge)", "native_hits"),
        ("sweed_serving_native_fallbacks_total",
         "native-handler requests punted to the bridged worker path", "native_fallbacks"),
        ("sweed_serving_qos_shed_total",
         "requests shed by the tenant governor (503 + Retry-After)", "qos_shed"),
        ("sweed_serving_qos_delayed_total",
         "requests paced by the tenant governor before admission", "qos_delayed"),
    ))


def register_qos_metrics(registry: Optional[Registry] = None) -> dict:
    """Per-tenant QoS evidence: a labelled latency histogram and a
    per-tenant admission-decision counter. Tenant keys are bounded: the
    governor keeps at most 1 024 tenants, and anonymous /24 classes are
    labelled only while the governor is on
    (``http_util.observe_tenant_request``)."""
    reg = registry or default_registry
    return {
        "hist": reg.histogram("sweed_qos_request_seconds", "request service time by tenant"),
        "decisions": reg.counter(
            "sweed_qos_decisions_total",
            "tenant-governor admissions by tenant and outcome (ok / delay / shed)"),
    }


def register_deadline_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the cross-daemon deadline's events
    (``util/deadline.counts``)."""

    def snap(key):
        from ..util import deadline

        return deadline.counts().get(key, 0)

    _gauges(registry or default_registry, snap, (
        ("sweed_deadline_clamped_total",
         "hop timeouts shortened to the remaining cross-daemon budget", "clamped"),
        ("sweed_deadline_refused_dial_total",
         "downstream calls refused because the budget was already spent", "refused_dial"),
        ("sweed_deadline_expired_inbound_total",
         "requests answered 504 on arrival: the deadline died upstream", "expired_inbound"),
        ("sweed_deadline_aborted_handler_total",
         "handlers aborted mid-work by DeadlineExceeded", "aborted_handler"),
    ))


def register_heat_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the volumes' heat, summed across every live store."""

    def snap(key):
        from .heat import heat_stats

        return heat_stats().get(key, 0)

    _gauges(registry or default_registry, snap, (
        ("sweed_heat_read", "decayed read-op heat summed over local volumes", "read_heat"),
        ("sweed_heat_write", "decayed write-op heat summed over local volumes",
         "write_heat"),
        ("sweed_heat_max_volume", "hottest single local volume (read+write heat)",
         "max_volume_heat"),
    ))


def register_ncache_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the hot-needle caches (one per volume server)."""

    def snap(key):
        from ..util.needle_cache import ncache_stats

        return ncache_stats().get(key, 0)

    _gauges(registry or default_registry, snap, (
        ("sweed_ncache_hits_total", "volume GETs answered from the hot-needle RAM cache",
         "hits"),
        ("sweed_ncache_misses_total", "cacheable volume GETs that fell through to disk",
         "misses"),
        ("sweed_ncache_evictions_total", "entries evicted to hold the byte budget",
         "evictions"),
        ("sweed_ncache_bytes", "payload bytes resident in the hot-needle cache", "bytes"),
        ("sweed_ncache_entries", "needles resident in the hot-needle cache", "entries"),
    ))


def register_fleet_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the master's EC scheduler: job counts, and the encode
    GB/s of each member keyed by its url."""
    reg = registry or default_registry

    def snap(key):
        from ..cluster.fleet import fleet_stats

        return fleet_stats().get(key, 0)

    _gauges(reg, snap, (
        ("sweed_fleet_members", "volume servers reporting torch.distributed mesh coordinates",
         "members"),
        ("sweed_fleet_jobs_scheduled_total", "EC jobs accepted by the fleet scheduler",
         "jobs_scheduled"),
        ("sweed_fleet_jobs_running", "EC jobs queued or in flight on a member",
         "jobs_running"),
        ("sweed_fleet_jobs_done_total", "EC jobs that committed their shard set",
         "jobs_done"),
        ("sweed_fleet_jobs_failed_total",
         "EC jobs that errored (member death, missing volume, ...)", "jobs_failed"),
        ("sweed_fleet_retries_total", "EC job dispatches re-queued onto a different member",
         "jobs_retried"),
        ("sweed_fleet_preempted_total",
         "running EC jobs pulled back because their member went dark", "jobs_preempted"),
    ))
    gbps = reg.gauge("sweed_fleet_member_encode_gbps",
                     "last observed encode throughput per member (volume bytes / wall s)")

    def push_members():
        # per-member label sets change: refresh them at every read
        from ..cluster.fleet import fleet_stats

        per = fleet_stats().get("member_gbps", {})
        for url, v in per.items():
            gbps.set(v, member=url)
        return len(per)

    reg.gauge("sweed_fleet_members_measured",
              "members with at least one completed encode job").set_function(push_members)


def register_lifecycle_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over the master's lifecycle controllers (cluster/lifecycle.py):
    cycle and action counters and the interlocks' tallies. The cycle and
    per-action latencies are the ``lifecycle_*_seconds`` histograms that
    module owns."""

    def snap(key):
        from ..cluster.lifecycle import lifecycle_stats  # it imports this module

        return lifecycle_stats().get(key, 0)

    _gauges(registry or default_registry, snap, (
        ("sweed_lifecycle_controllers", "live lifecycle controllers in this process",
         "controllers"),
        ("sweed_lifecycle_paused", "controllers currently paused by an operator", "paused"),
        ("sweed_lifecycle_cycles_total", "observe→plan→execute cycles started", "cycles"),
        ("sweed_lifecycle_actions_done_total", "lifecycle actions executed to completion",
         "actions_done"),
        ("sweed_lifecycle_actions_failed_total", "lifecycle actions that errored",
         "actions_failed"),
        ("sweed_lifecycle_actions_deferred_total",
         "actions deferred because the load interlock saw a traffic peak",
         "actions_deferred"),
        ("sweed_lifecycle_cycles_deferred_total", "whole cycles deferred by the load interlock",
         "cycles_deferred"),
        ("sweed_lifecycle_cycles_skipped_locked_total",
         "cycles skipped because a shell held the cluster admin lock",
         "cycles_skipped_locked"),
        ("sweed_lifecycle_recovered_resumed_total",
         "journal-replay actions re-validated and re-executed after failover", "resumed"),
        ("sweed_lifecycle_recovered_abandoned_total",
         "journal-replay actions abandoned (never started before the crash)", "abandoned"),
    ))


def register_sync_metrics(registry: Optional[Registry] = None) -> None:
    """Gauges over live cross-cluster sync directions
    (``replication/controller.sync_stats``): per-direction lag plus
    process-wide totals. The snapshot is network-free by construction, so
    these gauges stay readable while the PEER cluster is down."""

    def snap(key):
        from ..replication.controller import sync_stats  # stats must not import replication at import

        return sync_stats()["totals"].get(key, 0)

    reg = registry or default_registry
    _gauges(reg, snap, (
        ("sweed_sync_replicated_total", "meta events applied to a peer cluster",
         "replicated"),
        ("sweed_sync_redelivered_total",
         "crash-window redeliveries proven no-ops by idempotence markers", "redelivered"),
        ("sweed_sync_lww_skipped_total",
         "conflicting writes dropped as the last-writer-wins loser", "lww_skipped"),
        ("sweed_sync_retries_total", "transient per-event apply retries", "retries"),
        ("sweed_sync_inflight",
         "events fetched but not yet applied, summed over directions", "inflight"),
        ("sweed_sync_dlq_depth", "poison events parked in a dead-letter queue",
         "dlq_depth"),
        ("sweed_sync_parked_total",
         "events classified poison and parked to the dead-letter queue", "parked"),
    ))
    lag = reg.gauge("sweed_sync_lag_s",
                    "replication lag per direction (last seen source ts - checkpoint)")

    def _push_lag():
        from ..replication.controller import sync_stats

        snapshot = sync_stats()
        for name, d in snapshot["directions"].items():
            lag.set(d.get("lag_s", 0.0), direction=name)
        return snapshot["totals"].get("max_lag_s", 0.0)

    reg.gauge("sweed_sync_max_lag_s", "worst-direction replication lag").set_function(_push_lag)


register_serving_metrics()
register_heat_metrics()
register_ncache_metrics()
register_fleet_metrics()
register_lifecycle_metrics()
register_deadline_metrics()
register_sync_metrics()
QOS_INSTRUMENTS = register_qos_metrics()


def note_qos_request(tenant: str, seconds: float) -> None:
    """Record one request's service time under its tenant label."""
    QOS_INSTRUMENTS["hist"].observe(seconds, tenant=tenant)


def note_qos_decision(tenant: str, outcome: str) -> None:
    """Count one governor admission decision (ok / delay / shed)."""
    QOS_INSTRUMENTS["decisions"].inc(tenant=tenant, outcome=outcome)


def register_query_metrics(registry: Optional[Registry] = None) -> dict[str, Counter]:
    """Counters for the scan engine (query/scan.py): rows and bytes pushed
    through scan plans, and the kernel-vs-exact-lane split that tells an
    operator whether their data shape vectorizes. Scans are labelled by
    backend (cuda / cpu), indexed segments by where the index ran (card /
    host)."""
    reg = registry or default_registry
    return {
        "rows": reg.counter("sweed_query_rows_scanned_total",
                            "documents evaluated by scan plans"),
        "bytes": reg.counter("sweed_query_bytes_scanned_total",
                             "object bytes fed through scan plans"),
        "kernel": reg.counter("sweed_query_rows_kernel_total",
                              "rows decided by the vectorized kernels, by backend label"),
        "fallback": reg.counter("sweed_query_rows_fallback_total",
                                "rows routed to the row-at-a-time exact lane"),
        "scans": reg.counter("sweed_query_scans_total",
                             "scan plan executions, by backend label"),
        "index_segments": reg.counter(
            "sweed_query_index_segments_total",
            "CSV segments structurally indexed, by where: card (csv_index.cu) or host (numpy)"),
    }


QUERY_COUNTERS = register_query_metrics()


def query_stats() -> dict:
    """Snapshot of the scan-engine counters."""
    return {
        "rows_scanned": QUERY_COUNTERS["rows"].total(),
        "bytes_scanned": QUERY_COUNTERS["bytes"].total(),
        "rows_kernel": QUERY_COUNTERS["kernel"].total(),
        "rows_fallback": QUERY_COUNTERS["fallback"].total(),
        "scans": QUERY_COUNTERS["scans"].total(),
    }


def register_scrub_metrics(registry: Optional[Registry] = None) -> dict[str, Counter]:
    """Counters for the background CRC scrub (server/volume_server.py,
    SWEED_SCRUB=1). They are process-wide: several volume servers in one
    process add into the same counters."""
    reg = registry or default_registry
    return {
        "checked": reg.counter("sweed_scrub_needles_checked_total",
                               "needle CRCs verified by the background scrub"),
        "bytes": reg.counter("sweed_scrub_bytes_total",
                             "needle payload bytes read back by the scrub"),
        "errors": reg.counter("sweed_scrub_crc_errors_total",
                              "needles whose stored CRC did not match the payload"),
        "rounds": reg.counter("sweed_scrub_rounds_total",
                              "full passes completed over a volume"),
    }


SCRUB_COUNTERS = register_scrub_metrics()


def scrub_stats() -> dict:
    """Snapshot of the scrub counters for /status."""
    return {
        "needles_checked": SCRUB_COUNTERS["checked"].total(),
        "bytes_read": SCRUB_COUNTERS["bytes"].total(),
        "crc_errors": SCRUB_COUNTERS["errors"].total(),
        "rounds": SCRUB_COUNTERS["rounds"].total(),
    }
