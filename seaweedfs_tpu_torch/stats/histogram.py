"""Latency histograms: Prometheus cumulative buckets, quantile estimates and
exemplars.

The reference's `weed/stats/metrics.go` histogramVec usage as a type the
status sections read percentiles from (the master's assign summary in
``/dir/status``, the fleet scheduler's job latency):

- cumulative bucket counts with ``_sum``/``_count``, as Prometheus keeps
  them;
- ``quantile()``/``summary()`` — p50/p99 estimated by linear interpolation
  inside the owning bucket (the estimate PromQL's ``histogram_quantile``
  computes server-side), so a status page answers without a scrape
  pipeline;
- exemplars — each bucket keeps the last (trace id, value) observed into
  it, and ``expose()`` appends it OpenMetrics-style (``... #
  {trace_id="..."} 0.0031``): the way from "p99 regressed" to the shell's
  ``trace <id>``. The trace id is the ambient span's (``stats/trace.py``)
  unless one is passed, and never a label, so it adds no cardinality.
- ``expose()`` — the Prometheus text lines ``/metrics`` serves
  (``stats/metrics.py`` registers the histograms), in the JAX package's
  format.
"""

from __future__ import annotations

import time
from typing import Optional

from ..util.locks import make_lock
from ..util.racecheck import instrument
from .trace import current_trace_id

_DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(v) -> str:
    """Prometheus text-format label escaping: backslash, double quote and
    newline are the three characters the format requires escaped."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


@instrument
class Histogram:
    """Prometheus-shaped histogram with quantile estimates.

    ``_counts[key][i]`` is CUMULATIVE: observations with value <=
    buckets[i] (the exposition's ``le`` semantics)."""

    def __init__(self, name: str, help_: str = "", buckets=None):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets or _DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = {}
        self._total: dict[tuple, int] = {}
        # per label set, per bucket: the last (trace_id, value) that landed
        # in it (None until one does); index len(buckets) is +Inf
        self._exemplars: dict[tuple, list] = {}
        self._lock = make_lock("Histogram._lock")

    def observe(self, value: float, trace_id: Optional[str] = None, **labels) -> None:
        if trace_id is None:
            trace_id = current_trace_id()
        key = tuple(sorted(labels.items()))
        # the first bucket the value fits; cumulative counts bump every
        # bucket at or above it
        slot = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if value <= b:
                slot = i
                break
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i in range(slot, len(self.buckets)):
                counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._total[key] = self._total.get(key, 0) + 1
            if trace_id:
                ex = self._exemplars.setdefault(key, [None] * (len(self.buckets) + 1))
                ex[slot] = (trace_id, value)

    def time(self, **labels):
        """with hist.time(op="read"): ..."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)

        return _Timer()

    def count(self, **labels) -> int:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._total.get(key, 0)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Estimated q-quantile (0 < q <= 1) in seconds, by linear
        interpolation within the owning bucket — histogram_quantile's
        estimate, computed in-process. None with no observations; the
        top bucket edge when the quantile lands in +Inf (the estimate
        is then a floor, same as PromQL's clamp)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.get(key)
            total = self._total.get(key, 0)
            if not counts or total <= 0:
                return None
            counts = list(counts)
        rank = q * total
        prev_count, prev_edge = 0, 0.0
        for i, b in enumerate(self.buckets):
            if counts[i] >= rank:
                in_bucket = counts[i] - prev_count
                if in_bucket <= 0:
                    return b
                frac = (rank - prev_count) / in_bucket
                return prev_edge + (b - prev_edge) * frac
            prev_count, prev_edge = counts[i], b
        return self.buckets[-1]

    def summary(self, **labels) -> dict:
        """Compact status block: count, mean and the p50/p99 estimates
        (milliseconds)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            total = self._total.get(key, 0)
            s = self._sum.get(key, 0.0)
        p50 = self.quantile(0.50, **labels)
        p99 = self.quantile(0.99, **labels)
        return {
            "count": total,
            "mean_ms": round(s / total * 1000.0, 3) if total else None,
            "p50_ms": round(p50 * 1000.0, 3) if p50 is not None else None,
            "p99_ms": round(p99 * 1000.0, 3) if p99 is not None else None,
        }

    def expose(self) -> list[str]:
        """Prometheus text lines: cumulative ``_bucket`` counts per ``le``
        (each with its exemplar, if any), then ``_sum`` and ``_count``, per
        label set."""
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = sorted(self._counts)
            counts = {k: list(v) for k, v in self._counts.items()}
            totals = dict(self._total)
            sums = dict(self._sum)
            exemplars = {k: list(v) for k, v in self._exemplars.items()}
        for key in keys:
            labels = dict(key)
            ex = exemplars.get(key)
            for i, b in enumerate(self.buckets):
                lb = {**labels, "le": repr(b)}
                out.append(f"{self.name}_bucket{_fmt_labels(lb)} {counts[key][i]}"
                           + _exemplar_suffix(ex, i))
            lb = {**labels, "le": "+Inf"}
            out.append(f"{self.name}_bucket{_fmt_labels(lb)} {totals[key]}"
                       + _exemplar_suffix(ex, len(self.buckets)))
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {sums[key]}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {totals[key]}")
        return out


def _exemplar_suffix(ex, i: int) -> str:
    """The OpenMetrics exemplar tail of one bucket line, or ''."""
    if not ex or ex[i] is None:
        return ""
    trace_id, value = ex[i]
    return f' # {{trace_id="{_escape_label_value(trace_id)}"}} {value:.6g}'
