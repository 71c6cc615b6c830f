"""Dapper-style distributed tracing across the port's daemons.

The port of the JAX package's ``stats/trace.py``:

- ``Span``: one timed hop (service, name, parentage, tags).
- Propagation: a ``contextvars.ContextVar`` holds the active span; every
  internal HTTP call (the transports of ``server/http_util.py`` and
  ``server/aio_transport.py``) injects ``X-Sweed-Trace: <trace_id>:<span_id>``,
  and every ``JsonHandler`` dispatch opens a server span parented on that
  header. Both serving cores keep it: the threads core runs handlers on the
  request thread, the aio reactor copies the loop task's context into its
  worker pool, and ``util/pipeline.py`` copies the submitting thread's
  context into its pools.
- Sampling: always on; ``SWEED_TRACE=0`` is the kill switch.
- Storage: finished spans land in a process-wide bounded ring
  (``SWEED_TRACE_RING`` spans, default 2048) that every daemon serves at
  ``/debug/traces`` (the filer at ``/_debug/traces``); ``assemble_tree``
  stitches the daemons' rings back into one tree (the shell's ``trace``
  command is not ported yet).
- Slow requests: a span slower than ``SWEED_TRACE_SLOW_MS`` (default 1000)
  logs a warning with its trace id.
- Layer spans: inside a request the port's layers open spans of their own
  (``daemon.needle_read``, ``query.index``, ``query.device``,
  ``query.rows``, ``daemon.reply``; ``ec.read``, ``ec.h2d``, ``ec.d2h``,
  ``ec.write``; ``store.sums``, ``store.commit``, ``store.ec_read``,
  ``store.fetch_sibling``, ``store.reconstruct``), each with its work as
  tags (bytes, rows, shards, files).
- Clock: a span stamps ``start_ns`` from ``time.time_ns()`` (the clock in
  which ``torch.profiler`` stamps device events) and ``end_ns`` as
  ``start_ns`` plus a ``perf_counter_ns`` delta, and records the native id
  of the thread it ran on.
- ``Recorder``: while one is open it receives every span the process
  finishes, besides the ring, so that a measured window keeps all of its
  spans however many the ring would drop.

Ids are random hex: 16 chars of trace id, 8 of span id.
"""

from __future__ import annotations

import contextvars
import os
import random
import threading
import time
from collections import deque
from typing import Optional

from ..util import glog
from ..util.locks import make_lock
from ..util.racecheck import instrument

TRACE_HEADER = "X-Sweed-Trace"
TRACE_ID_HEADER = "X-Sweed-Trace-Id"  # response: tells the client its trace
# request, set by the native engine on what it proxies to the daemon: when
# it began to proxy, in ns since the epoch (CLOCK_REALTIME)
ENGINE_NS_HEADER = "X-Sweed-Engine-Ns"


def enabled() -> bool:
    """Tracing kill switch; read per call so tests flip it live."""
    return os.environ.get("SWEED_TRACE", "1").strip() != "0"


def ring_capacity() -> int:
    raw = os.environ.get("SWEED_TRACE_RING", "2048").strip()
    if not (raw.isascii() and raw.isdigit()) or int(raw) < 1:
        return 2048
    return int(raw)


# parse memo for the per-span-exit threshold read: the env STRING is
# still fetched every call (live knob), but strip/float only rerun when
# it changes — this sits on every request's span-close path
_slow_cache: tuple[Optional[str], float] = (None, 1.0)


def slow_threshold_s() -> float:
    global _slow_cache
    raw = os.environ.get("SWEED_TRACE_SLOW_MS", "1000")
    cached_raw, cached = _slow_cache
    if raw == cached_raw:
        return cached
    try:
        ms = float(raw.strip())
    except ValueError:
        ms = 1000.0
    val = max(0.0, ms) / 1000.0
    _slow_cache = (raw, val)
    return val


# ids need uniqueness, not unpredictability: a process-seeded PRNG skips a
# getrandom syscall per span; getrandbits is one C call, atomic under the
# GIL
_rand = random.Random(os.urandom(16))


def _new_trace_id() -> str:
    return f"{_rand.getrandbits(64):016x}"


def _new_span_id() -> str:
    return f"{_rand.getrandbits(32):08x}"


class Span:
    """One timed hop. Mutable while open (handlers add tags/status);
    finished by the time it lands in the ring, so query-time to_dict
    sees settled state."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "service",
        "start_ns", "end_ns", "thread", "tags", "status",
    )

    def __init__(
        self,
        name: str,
        service: str = "",
        trace_id: str = "",
        parent_id: str = "",
    ):
        self.trace_id = trace_id or _new_trace_id()
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.start_ns = self.end_ns = time.time_ns()
        self.thread = threading.get_native_id()
        self.tags: dict = {}
        self.status = "ok"

    @property
    def start(self) -> float:
        """Seconds since the epoch."""
        return self.start_ns / 1e9

    @property
    def duration(self) -> float:
        """Seconds."""
        return (self.end_ns - self.start_ns) / 1e9

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start": self.start,
            "duration_ms": round(self.duration * 1000.0, 3),
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "thread": self.thread,
            "tags": dict(self.tags),
            "status": self.status,
        }


_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "sweed_trace_span", default=None
)


def current_span() -> Optional[Span]:
    return _current.get()


def current_trace_id() -> str:
    s = _current.get()
    return s.trace_id if s is not None else ""


def inject_header() -> Optional[str]:
    """Header value for an outbound internal HTTP call, or None when no
    span is active (requests that originate outside a trace stay clean)."""
    if not enabled():
        return None
    s = _current.get()
    if s is None:
        return None
    return f"{s.trace_id}:{s.span_id}"


def parse_header(value: Optional[str]) -> tuple[str, str]:
    """('trace_id', 'parent_span_id') from an X-Sweed-Trace value; empty
    strings for absent/garbage (a fresh root trace starts instead)."""
    if not value:
        return "", ""
    trace_id, _, parent = value.strip().partition(":")
    if not trace_id or not parent:
        return "", ""
    if not (trace_id.isascii() and trace_id.isalnum()
            and parent.isascii() and parent.isalnum()):
        return "", ""
    return trace_id, parent


@instrument
class TraceRing:
    """Process-wide bounded ring of finished spans.

    One ring per PROCESS, not per daemon: in-process test clusters share
    it (span ids stay unique, so the shell's assembler dedups cleanly),
    while production daemons — one process each — get the per-daemon
    ring the /debug/traces contract describes.

    The ring holds the finished Span objects themselves; to_dict runs at
    QUERY time (/debug/traces, tests), keeping the per-request add() to
    a lock + deque append."""

    def __init__(self, capacity: Optional[int] = None):
        self._lock = make_lock("TraceRing._lock")
        self._capacity = capacity or ring_capacity()
        self._spans: deque = deque(maxlen=self._capacity)
        self._added = 0

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
            self._added += 1

    def for_trace(self, trace_id: str) -> list[dict]:
        with self._lock:
            found = [s for s in self._spans if s.trace_id == trace_id]
        return [s.to_dict() for s in found]

    def snapshot(self, limit: int = 256) -> list[dict]:
        """Newest-last tail of the ring."""
        with self._lock:
            spans = list(self._spans)
        return [s.to_dict() for s in spans[-max(0, limit):]]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def stats(self) -> dict:
        with self._lock:
            size, added = len(self._spans), self._added
        return {
            "enabled": enabled(),
            "capacity": self._capacity,
            "size": size,
            "added": added,
            "dropped": max(0, added - size) if size >= self._capacity else 0,
        }


RING = TraceRing()


def trace_stats() -> dict:
    """Snapshot for /_status sections."""
    return RING.stats()


class Recorder:
    """Every span the process finishes while it is open, in finish order,
    besides the ring: ``with Recorder() as rec: ...`` then ``rec.spans``
    (the ``Span`` objects) or ``rec.dicts()``."""

    def __init__(self):
        self.spans: list[Span] = []

    def open(self) -> "Recorder":
        with _recorders_lock:
            _recorders.append(self)
        return self

    def close(self) -> None:
        with _recorders_lock:
            if self in _recorders:
                _recorders.remove(self)

    def __enter__(self) -> "Recorder":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    def dicts(self) -> list[dict]:
        return [s.to_dict() for s in self.spans]


_recorders: list[Recorder] = []
_recorders_lock = threading.Lock()


class _SpanScope:
    """Context manager that owns one span's contextvar window. ``span``
    is None when tracing is disabled — callers guard tag writes on it, or
    use ``tag``. ``seconds`` is the time between enter and exit, measured
    whether or not a span is recorded, so a caller that keeps its own
    tally reads the span's own stamps."""

    __slots__ = ("span", "seconds", "_token", "_t0")

    def __init__(self, span: Optional[Span]):
        self.span = span
        self.seconds = 0.0
        self._token = None
        self._t0 = 0

    def tag(self, **tags) -> None:
        if self.span is not None:
            self.span.tags.update(tags)

    def __enter__(self) -> Optional[Span]:
        if self.span is not None:
            self._token = _current.set(self.span)
            self.span.start_ns = time.time_ns()
        self._t0 = time.perf_counter_ns()
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        dt_ns = time.perf_counter_ns() - self._t0
        self.seconds = dt_ns / 1e9
        if self.span is None:
            return
        _current.reset(self._token)
        self.span.end_ns = self.span.start_ns + dt_ns
        if exc_type is not None:
            self.span.status = "error"
            self.span.tags.setdefault("error", exc_type.__name__)
        RING.add(self.span)
        # read without the lock: a recorder opened or closed at this
        # instant may miss the span, never the rest of its window
        for rec in _recorders:
            rec.spans.append(self.span)
        slow = slow_threshold_s()
        if slow and self.seconds >= slow:
            glog.warning(
                "slow request: %s %s took %.1fms (trace %s span %s)",
                self.span.service, self.span.name,
                self.seconds * 1000.0,
                self.span.trace_id, self.span.span_id,
            )


def start_span(
    name: str,
    service: str = "",
    parent_header: Optional[str] = None,
    **tags,
) -> _SpanScope:
    """Open a span: parented on ``parent_header`` (an inbound
    X-Sweed-Trace value) when given, else on the context's active span,
    else a fresh root trace. Usable as ``with start_span(...) as span:``;
    yields None (and records nothing) when tracing is off."""
    if not enabled():
        return _SpanScope(None)
    trace_id, parent_id = parse_header(parent_header)
    if not trace_id:
        cur = _current.get()
        if cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
    span = Span(name, service=service, trace_id=trace_id,
                parent_id=parent_id)
    if tags:
        span.tags.update(tags)
    return _SpanScope(span)


def h_debug_traces(handler, path, query, body):
    """Shared ``GET /debug/traces`` route handler: the daemon's view of
    the span ring. ``?trace=<id>`` filters to one trace; ``?limit=N``
    bounds the unfiltered tail (default 256)."""
    trace_id = query.get("trace", "").strip()
    raw = query.get("limit", "256").strip()
    limit = int(raw) if raw.isascii() and raw.isdigit() else 256
    spans = (RING.for_trace(trace_id) if trace_id
             else RING.snapshot(min(limit, 4096)))
    return 200, {
        "service": getattr(handler, "trace_service", ""),
        "ring": RING.stats(),
        "spans": spans,
    }


def assemble_tree(spans: list[dict]) -> list[dict]:
    """Parent-linked forest from a flat span list (deduped by span id):
    each node is the span dict plus a ``children`` list, children sorted
    by start time. Roots are spans whose parent is absent from the set —
    sorted by start so concurrent root fragments read chronologically."""
    by_id: dict[str, dict] = {}
    for s in spans:
        node = dict(s)
        node["children"] = []
        by_id.setdefault(node["span_id"], node)
    roots = []
    for node in by_id.values():
        parent = by_id.get(node["parent_id"]) if node["parent_id"] else None
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n["start"])
    roots.sort(key=lambda n: n["start"])
    return roots


def format_tree(roots: list[dict]) -> str:
    """Human-readable tree with per-hop timings."""
    lines: list[str] = []

    def walk(node: dict, depth: int) -> None:
        tag_bits = ""
        status = node.get("status", "ok")
        if status != "ok":
            tag_bits += f" [{status}]"
        http_status = node.get("tags", {}).get("status")
        if http_status is not None:
            tag_bits += f" ({http_status})"
        lines.append(
            f"{'  ' * depth}{node['service'] or '?'} {node['name']} "
            f"{node['duration_ms']}ms{tag_bits} "
            f"span={node['span_id']}"
        )
        for child in node["children"]:
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)
