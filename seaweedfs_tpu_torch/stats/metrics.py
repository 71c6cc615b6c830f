"""Labelled counters, and the query engine's and the scrub's metrics.

The part of the reference's metrics (`weed/stats/metrics.go`) that the scan
engine and the background scrub need: a thread-safe labelled ``Counter``,
and the ``sweed_query_*`` and ``sweed_scrub_*`` counters under the
reference's names. The counters are bumped from the
volume servers' request and scrub threads, so every read and update takes the
counter's lock. The registry and its exposition come with ``/metrics``.
"""

from __future__ import annotations

import threading


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

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


def register_query_metrics() -> dict[str, Counter]:
    """Counters for the scan engine (query/scan.py): rows and bytes pushed
    through scan plans, and the kernel-vs-exact-lane split that tells an
    operator whether their data shape vectorizes. Scans are labelled by
    backend (cuda / cpu)."""
    return {
        "rows": Counter("sweed_query_rows_scanned_total",
                        "documents evaluated by scan plans"),
        "bytes": Counter("sweed_query_bytes_scanned_total",
                         "object bytes fed through scan plans"),
        "kernel": Counter("sweed_query_rows_kernel_total",
                          "rows decided by the vectorized kernels"),
        "fallback": Counter("sweed_query_rows_fallback_total",
                            "rows routed to the row-at-a-time exact lane"),
        "scans": Counter("sweed_query_scans_total",
                         "scan plan executions, by backend label"),
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


def register_scrub_metrics() -> dict[str, Counter]:
    """Counters for the background CRC scrub (server/volume_server.py,
    SWEED_SCRUB=1). They are process-wide: several volume servers in one
    process add into the same counters."""
    return {
        "checked": Counter("sweed_scrub_needles_checked_total",
                           "needle CRCs verified by the background scrub"),
        "bytes": Counter("sweed_scrub_bytes_total",
                         "needle payload bytes read back by the scrub"),
        "errors": Counter("sweed_scrub_crc_errors_total",
                          "needles whose stored CRC did not match the payload"),
        "rounds": Counter("sweed_scrub_rounds_total",
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
