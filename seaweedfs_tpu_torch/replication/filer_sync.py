"""Continuous filer→filer cluster sync: the port's copy of the JAX package's
``replication/filer_sync.py`` (reference `command/filer_sync.go:81`),
hardened for the datacenter-loss scenario: crash-idempotent apply, LWW
conflict resolution, bounded retry, dead-lettering.

One `FilerSync` replicates source→target; run two (swapped) for
active-active — `ReplicationController` owns that pairing. Loop prevention
(`filer_sync.go:116`): writes to the target carry the SOURCE filer's
signature, so events they generate on the target are recognized by the
reverse syncer (exclude_signature = its own source's signature) and skipped.

Crash-proofing — the protocol, per event::

    check idempotence marker ──► LWW gate ──► apply (bounded retry)
          ──► write marker ──► [batch] advance offset ──► GC markers

The idempotence marker is a deterministic KV key in the TARGET cluster,
``repl.applied.<source_signature>.<ts_ns>.<path-hash>`` — the cross-cluster
extension of the EC path's `.commit` manifest: a tiny durable record that an
irreversible step completed, written AFTER the step, checked BEFORE
repeating it. Walk the crash windows:

* crash before apply → nothing happened; redelivery applies. No drop.
* crash between apply and marker → redelivery re-applies the SAME bytes to
  the SAME path (apply is convergent, not additive). No dupe.
* crash between marker and offset checkpoint → redelivery hits the marker
  and is a no-op. No dupe.
* crash between checkpoint and marker GC → leftover markers are dead weight
  only; events at-or-before the checkpoint are never redelivered.

The offset checkpoint (`setOffset/getOffset`, kept in the target's KV so a
restarted syncer resumes where the TARGET durably got to) advances only
after every event before it is applied — on a mid-batch stall it advances
to the durable prefix.

Conflict resolution for concurrent A/B writes to the same path is
last-writer-wins at SECOND granularity with the writer's cluster signature
as tiebreak: apply an incoming event iff ``(ev_s, src_sig) > (tgt_s,
tgt_writer_sig)``. Seconds, not nanoseconds, because `Entry.mtime` is
second-resolution — comparing ns event time against a second-truncated
mtime makes the two clusters disagree about the same write. Replicated
applies stamp ``Repl-Ts``/``Repl-Src`` extended attrs so the target
remembers the ORIGIN write's identity; a local entry's identity is
``(mtime, own_signature)``. Both clusters evaluate the same total order,
so exactly one direction applies and both converge. Same-source events skip
the gate entirely — the meta log already orders them, and two writes within
one second must both land.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Optional

from ..filer.client import FilerClient
from ..stats import trace as _trace
from ..stats.metrics import default_registry
from ..util import faultpoints, glog
from ..util.retry import (
    REPLICATION_POLICY,
    RetryError,
    RetryPolicy,
    backoff_delays,
    retry_call,
)
from .replicator import Replicator
from .sink import FilerSink

#: paces the outer poll loop while a peer cluster is down — the loop never
#: exits (datacenter loss is survivable, not fatal), it just slows down
LOOP_POLICY = RetryPolicy(attempts=6, base_s=0.2, cap_s=5.0, deadline_s=1e9)

#: cross-cluster apply latency (event fetch excluded): one bucket set per
#: process, label = sync direction name (bounded by configured directions)
APPLY_HIST = default_registry.histogram(
    "replication_apply_seconds", "cross-cluster event apply latency"
)


class SyncStalled(Exception):
    """A transient failure survived bounded per-event retry; the batch
    checkpointed its durable prefix and the cycle ended early. The outer
    loop backs off and re-polls — nothing was skipped."""


class FilerSync:
    def __init__(
        self,
        source_url: str,
        target_url: str,
        source_path: str = "/",
        target_path: str = "",
        poll_interval: float = 0.2,
        direction: str = "",
        dlq=None,
        retry_policy: RetryPolicy = REPLICATION_POLICY,
    ):
        self.source = FilerClient(source_url)
        self.target = FilerClient(target_url)
        self.source_url = source_url
        self.target_url = target_url
        self.direction = direction or f"{source_url}->{target_url}"
        self.dlq = dlq
        self.retry_policy = retry_policy
        self.src_sig = self.source.status().get("signature", 0)
        self.tgt_sig = self.target.status().get("signature", 0)
        self.sink = FilerSink(
            target_url, path_prefix=target_path, signatures=[self.src_sig]
        )
        self.replicator = Replicator(
            self.sink,
            read_content=self._read_source,
            source_path=source_path,
            # events that already carry the target's signature came FROM the
            # target via the reverse syncer — do not bounce them back
            exclude_signature=self.tgt_sig,
        )
        self.source_path = source_path.rstrip("/") or "/"
        self.target_path = target_path.rstrip("/")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.poll_interval = poll_interval
        # counters surfaced by stats() → sweed_sync_* gauges. stats() must
        # stay network-free (/_status calls it while the peer may be DOWN),
        # so the offset is cached, not re-fetched.
        self.redelivered = 0
        self.lww_skipped = 0
        self.retries = 0
        self.parked = 0
        self.stalls = 0
        self.inflight = 0
        self.last_seen_ts = 0
        self._offset_cache = 0

    # -- offset checkpointing in the target's KV (filer_sync.go getOffset) --
    @property
    def _offset_key(self) -> str:
        return f"sync.offset.{self.source_url}"

    def _get_offset(self) -> int:
        v = self.target.kv_get(self._offset_key)
        self._offset_cache = int(v) if v else 0
        return self._offset_cache

    def _set_offset(self, ts_ns: int) -> None:
        self.target.kv_put(self._offset_key, str(ts_ns).encode())
        self._offset_cache = ts_ns

    # -- idempotence markers --------------------------------------------------
    def _marker_key(self, ev: dict, path: str) -> str:
        h = hashlib.sha1(path.encode()).hexdigest()[:16]
        return f"repl.applied.{self.src_sig}.{ev['ts_ns']}.{h}"

    @staticmethod
    def _event_path(ev: dict) -> Optional[str]:
        for side in ("new_entry", "old_entry"):
            e = ev.get(side)
            if e and e.get("full_path"):
                return e["full_path"]
        return None

    # -- source/target plumbing ----------------------------------------------
    def _read_source(self, path: str) -> bytes | None:
        faultpoints.fire("repl.read.source")
        status, data, _ = self.source.get_object(path)
        return data if status == 200 else None

    def _target_path_of(self, source_full_path: str) -> str:
        p = source_full_path
        if self.source_path != "/":
            p = p[len(self.source_path):] or "/"
        return self.target_path + p if self.target_path else p

    # -- LWW conflict gate ----------------------------------------------------
    def _lww_should_apply(self, ev: dict) -> bool:
        new = ev.get("new_entry")
        if not new or new.get("is_directory"):
            return True  # deletes propagate; mkdir is idempotent
        tgt = self.target.get_entry(self._target_path_of(new["full_path"]))
        if tgt is None:
            return True
        ext = tgt.get("extended") or {}
        try:
            tgt_s = int(ext["Repl-Ts"])
            tgt_src = int(ext["Repl-Src"])
        except (KeyError, TypeError, ValueError):
            tgt_s = int(tgt.get("mtime", 0))
            tgt_src = self.tgt_sig
        if tgt_src == self.src_sig:
            # target's last write came from THIS source: the meta log has
            # already ordered the events, and two same-second writes must
            # both land — the gate is only for cross-writer conflicts
            return True
        ev_s = ev["ts_ns"] // 1_000_000_000
        return (ev_s, self.src_sig) > (tgt_s, tgt_src)

    # -- apply ----------------------------------------------------------------
    def _apply(self, ev: dict) -> None:
        ev_s = ev["ts_ns"] // 1_000_000_000
        self.sink.stamp = {
            "Repl-Ts": str(ev_s),
            "Repl-Src": str(self.src_sig),
        }
        try:
            # the sync thread has no ambient request context: root a fresh
            # trace here so the target-filer hops (sink writes ride the
            # pooled transport, which injects the header) nest under it
            with _trace.start_span(
                "apply", service="replication",
                direction=self.direction, ts_ns=str(ev["ts_ns"]),
            ), APPLY_HIST.time(direction=self.direction):
                self.replicator.replicate(ev)
        finally:
            self.sink.stamp = {}

    def _park(self, ev: dict, err: Exception) -> None:
        self.parked += 1
        if self.dlq is None:
            glog.error("%s: poison event ts=%s dropped (no dlq): %s",
                       self.direction, ev.get("ts_ns"), err)
            return
        self.dlq.park(self.direction, self.source_url, self.target_url,
                      ev, err, read_content=self._read_source)

    def _process_event(self, ev: dict) -> Optional[str]:
        """Apply one event idempotently; returns the marker key written (or
        found), None when the event needed no marker. Raises SyncStalled
        when transient retry exhausts — the caller must NOT advance past it."""
        sigs = ev.get("signatures") or []
        excl = self.replicator.exclude_signature
        if excl and excl in sigs:
            self.replicator.skipped += 1
            return None
        path = self._event_path(ev)
        if path is None:
            return None
        mk = self._marker_key(ev, path)
        if self.target.kv_get(mk) is not None:
            self.redelivered += 1  # crash-window redelivery: proven no-op
            return mk
        if not self._lww_should_apply(ev):
            # losing side of a concurrent-write conflict; re-evaluating on
            # redelivery reaches the same verdict, so no marker needed
            self.lww_skipped += 1
            return None

        def _on_retry(e, attempt, delay):
            self.retries += 1
            glog.warning("%s: apply ts=%s attempt %d failed (%s); "
                         "retrying in %.2fs", self.direction,
                         ev.get("ts_ns"), attempt, e, delay)

        try:
            retry_call(self._apply, ev, policy=self.retry_policy,
                       on_retry=_on_retry)
        except RetryError as e:
            if e.permanent:
                self._park(ev, e)  # poison: park and move on, replayable
                return None
            raise SyncStalled(str(e)) from e
        faultpoints.fire("repl.apply.marker")
        self.target.kv_put(mk, b"1")
        return mk

    # -- the poll cycle -------------------------------------------------------
    def sync_once(self, limit: int = 1000) -> int:
        """One poll cycle; returns the number of events processed. Raises
        (connection errors, SyncStalled) when the cycle could not finish —
        after checkpointing whatever prefix DID apply durably."""
        since = self._get_offset()
        resp = self.source.meta_events(since_ns=since, limit=limit)
        events = resp.get("events", [])
        if not events:
            self.inflight = 0
            return 0
        self.last_seen_ts = events[-1]["ts_ns"]
        self.inflight = len(events)
        marker_keys: list[str] = []
        applied_ts = since
        processed = 0
        stall: Optional[SyncStalled] = None
        for ev in events:
            try:
                mk = self._process_event(ev)
            except SyncStalled as e:
                self.stalls += 1
                stall = e
                break
            if mk is not None:
                marker_keys.append(mk)
            applied_ts = ev["ts_ns"]
            processed += 1
            self.inflight = len(events) - processed
        if applied_ts > since:
            # everything at-or-before applied_ts is applied AND its marker
            # is durable in the target — only now may the offset move
            faultpoints.fire("repl.offset.checkpoint")
            self._set_offset(applied_ts)
            for mk in marker_keys:
                # GC: events ≤ checkpoint can never redeliver, so their
                # markers are dead weight in the target KV. A crash mid-GC
                # leaks a few harmless keys.
                self.target.kv_delete(mk)
        self.inflight = 0
        if stall is not None:
            raise stall
        return processed

    def run_forever(self) -> None:
        delays = None
        while not self._stop.is_set():
            try:
                n = self.sync_once()
            except Exception as e:  # noqa: BLE001 — peer loss must not kill the loop
                if delays is None:
                    delays = backoff_delays(LOOP_POLICY)
                d = next(delays, LOOP_POLICY.cap_s)
                glog.warning("%s: sync cycle failed (%s: %s); backing off "
                             "%.2fs", self.direction, type(e).__name__, e, d)
                self._stop.wait(d)
                continue
            delays = None  # healthy cycle resets the backoff schedule
            if n == 0:
                self._stop.wait(self.poll_interval)

    def start(self) -> "FilerSync":
        self._thread = threading.Thread(target=self.run_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- observability --------------------------------------------------------
    def stats(self) -> dict:
        lag_s = 0.0
        # offset 0 = nothing checkpointed yet; event-ts minus zero would
        # report ~56 years of "lag", so the gauge stays 0 until the first
        # durable checkpoint gives it a real reference point
        if self._offset_cache and self.last_seen_ts > self._offset_cache:
            lag_s = (self.last_seen_ts - self._offset_cache) / 1e9
        return {
            "direction": self.direction,
            "source": self.source_url,
            "target": self.target_url,
            "running": bool(self._thread and self._thread.is_alive()),
            "replicated": self.replicator.replicated,
            "skipped": self.replicator.skipped,
            "redelivered": self.redelivered,
            "lww_skipped": self.lww_skipped,
            "retries": self.retries,
            "parked": self.parked,
            "stalls": self.stalls,
            "inflight": self.inflight,
            "offset_ns": self._offset_cache,
            "lag_s": round(lag_s, 3),
            # apply-latency quantiles from the replication_apply_seconds
            # histogram (same buckets that feed /metrics)
            "apply_latency": APPLY_HIST.summary(direction=self.direction),
        }
