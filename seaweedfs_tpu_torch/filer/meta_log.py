"""Meta log: every filer mutation as a persisted, subscribable event stream.

Mirrors `weed/filer/filer_notify.go` + `util/log_buffer/log_buffer.go`:
mutations append EventNotifications to an in-memory ring AND (when a persist
dir is configured) to on-disk jsonl segment files, the analog of the
reference flushing log-buffer segments as chunked files under
`/topics/.system/log/<date>/` (filer_notify.go:84 logFlushFunc). Subscribers
replay persisted-then-memory from a timestamp and tail live; restart loses
nothing.

Every event carries a monotonically increasing ``seq`` (persisted), so
subscribers can detect gaps: if a subscriber asks for events older than
``oldest_ts_ns()`` (e.g. after segments were pruned), the reply is flagged
and the client must resync from a snapshot instead of losing events
silently.

The port's copy of the JAX package's ``filer/meta_log.py``; both packages read and
write the same formats.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..util import glog

_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".jsonl"


@dataclass
class EventNotification:
    ts_ns: int
    directory: str
    old_entry: Optional[dict]  # Entry dicts (None for create/delete sides)
    new_entry: Optional[dict]
    delete_chunks: bool = False
    is_from_other_cluster: bool = False
    signatures: list[int] = field(default_factory=list)
    seq: int = 0

    def to_dict(self) -> dict:
        return {
            "ts_ns": self.ts_ns,
            "directory": self.directory,
            "old_entry": self.old_entry,
            "new_entry": self.new_entry,
            "delete_chunks": self.delete_chunks,
            "is_from_other_cluster": self.is_from_other_cluster,
            "signatures": self.signatures,
            "seq": self.seq,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EventNotification":
        return cls(
            ts_ns=d["ts_ns"],
            directory=d.get("directory", ""),
            old_entry=d.get("old_entry"),
            new_entry=d.get("new_entry"),
            delete_chunks=d.get("delete_chunks", False),
            is_from_other_cluster=d.get("is_from_other_cluster", False),
            signatures=d.get("signatures", []),
            seq=d.get("seq", 0),
        )


class MetaLog:
    def __init__(
        self,
        capacity: int = 100_000,
        persist_dir: Optional[str] = None,
        segment_events: int = 4096,
    ):
        self.capacity = capacity
        self.persist_dir = persist_dir
        self.segment_events = segment_events
        self._events: list[EventNotification] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._subscribers: dict[str, Callable[[EventNotification], None]] = {}
        self._next_seq = 1
        self._last_ts_ns = 0
        self._seg_fh = None
        self._seg_count = 0
        # (seq, ts) of the oldest surviving persisted event; a first seq > 1
        # means earlier history was pruned — detectable across restarts
        self._oldest_persisted: Optional[tuple[int, int]] = None
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._recover()

    # -- persistence ---------------------------------------------------------
    def _segments(self) -> list[str]:
        if not self.persist_dir:
            return []
        return sorted(
            f
            for f in os.listdir(self.persist_dir)
            if f.startswith(_SEG_PREFIX) and f.endswith(_SEG_SUFFIX)
        )

    def _recover(self) -> None:
        """Resume seq numbering (and oldest-available ts) from disk."""
        segs = self._segments()
        if not segs:
            return
        self._load_oldest(segs)
        # last seq: last line of the last segment
        last_seq = last_ts = 0
        with open(os.path.join(self.persist_dir, segs[-1])) as f:
            for line in f:
                line = line.strip()
                if line:
                    d = json.loads(line)
                    last_seq, last_ts = d["seq"], d["ts_ns"]
        self._next_seq = last_seq + 1
        # keep ts monotone across restarts too (clock may have stepped back)
        self._last_ts_ns = last_ts

    def _persist(self, ev: EventNotification) -> None:
        if not self.persist_dir:
            return
        if self._seg_fh is None or self._seg_count >= self.segment_events:
            if self._seg_fh is not None:
                self._seg_fh.close()
            name = f"{_SEG_PREFIX}{ev.seq:020d}{_SEG_SUFFIX}"
            self._seg_fh = open(os.path.join(self.persist_dir, name), "a")
            self._seg_count = 0
        self._seg_fh.write(json.dumps(ev.to_dict()) + "\n")
        self._seg_fh.flush()
        self._seg_count += 1
        if self._oldest_persisted is None:
            self._oldest_persisted = (ev.seq, ev.ts_ns)

    def _read_persisted(self, since_ts_ns: int) -> list[EventNotification]:
        out: list[EventNotification] = []
        for seg in self._segments():
            path = os.path.join(self.persist_dir, seg)
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        d = json.loads(line)
                        if d["ts_ns"] > since_ts_ns:
                            out.append(EventNotification.from_dict(d))
            except FileNotFoundError:
                continue  # pruned under us
        return out

    def prune_segments(self, keep: int = 8) -> int:
        """Drop all but the newest ``keep`` segments (log retention). Returns
        the number removed; subscribers older than the new oldest_ts get a
        gap signal on their next poll."""
        removed = 0
        with self._lock:
            segs = self._segments()
            for seg in segs[:-keep] if keep else segs:
                try:
                    os.remove(os.path.join(self.persist_dir, seg))
                    removed += 1
                except FileNotFoundError:
                    pass
            self._load_oldest(self._segments())
        return removed

    def _load_oldest(self, segs: list[str]) -> None:
        self._oldest_persisted = None
        if segs:
            with open(os.path.join(self.persist_dir, segs[0])) as f:
                first = f.readline().strip()
                if first:
                    d = json.loads(first)
                    self._oldest_persisted = (d["seq"], d["ts_ns"])

    # -- append / replay -----------------------------------------------------
    def append(
        self,
        directory: str,
        old_entry: Optional[dict],
        new_entry: Optional[dict],
        delete_chunks: bool = False,
        signatures: Optional[list[int]] = None,
        is_from_other_cluster: bool = False,
    ) -> EventNotification:
        ev = EventNotification(
            ts_ns=0,
            directory=directory,
            old_entry=old_entry,
            new_entry=new_entry,
            delete_chunks=delete_chunks,
            is_from_other_cluster=is_from_other_cluster,
            signatures=signatures or [],
        )
        with self._lock:
            # stamp under the lock so ts order always matches seq order —
            # a pre-lock stamp lets a preempted thread append an OLDER ts
            # after a newer one, and ts-cursor pollers then skip it forever
            ev.ts_ns = max(time.time_ns(), self._last_ts_ns + 1)
            self._last_ts_ns = ev.ts_ns
            ev.seq = self._next_seq
            self._next_seq += 1
            self._events.append(ev)
            if len(self._events) > self.capacity:
                self._events = self._events[-self.capacity :]
            self._persist(ev)
            subs = list(self._subscribers.values())
            self._cond.notify_all()
        for fn in subs:
            try:
                fn(ev)
            except Exception:
                glog.exception("meta-log subscriber failed")
        return ev

    def oldest_ts_ns(self) -> int:
        """Timestamp before which history is no longer available (0 = full
        history retained — poll with since_ns < this means events were lost
        to pruning and the subscriber must resync)."""
        with self._lock:
            if self.persist_dir:
                if self._oldest_persisted and self._oldest_persisted[0] > 1:
                    return self._oldest_persisted[1]
                return 0
            if self._events and self._events[0].seq > 1:  # ring dropped some
                return self._events[0].ts_ns
            return 0

    def replay_since(self, ts_ns: int) -> list[EventNotification]:
        """Persisted-then-memory replay, deduped by seq, ordered by seq."""
        with self._lock:
            mem = [e for e in self._events if e.ts_ns > ts_ns]
            mem_seqs = {e.seq for e in mem}
            # memory fast path: ts is monotone with seq, so when the ring's
            # oldest event is at or before the cursor (or the ring still holds
            # seq 1), everything after the cursor is in memory — skip the
            # full-segment disk scan that would otherwise run on every poll
            ring_covers = bool(self._events) and (
                self._events[0].seq == 1 or self._events[0].ts_ns <= ts_ns
            )
        if self.persist_dir and not ring_covers:
            disk = [
                e for e in self._read_persisted(ts_ns) if e.seq not in mem_seqs
            ]
            return sorted(disk + mem, key=lambda e: e.seq)
        return mem

    def wait_since(
        self, ts_ns: int, timeout: float = 0.0
    ) -> list[EventNotification]:
        """replay_since with long-poll: if empty, block up to ``timeout``
        seconds for a new event."""
        events = self.replay_since(ts_ns)
        if events or timeout <= 0:
            return events
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._events or self._events[-1].ts_ns <= ts_ns:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        return self.replay_since(ts_ns)

    # -- push subscribers ----------------------------------------------------
    def subscribe(
        self,
        name: str,
        fn: Callable[[EventNotification], None],
        since_ts_ns: int = 0,
    ) -> None:
        """Replay events after since_ts_ns, then tail live. The snapshot and
        registration happen under one lock hold so no event can fall between
        replay and tail (live events may interleave with the replay delivery,
        but none are lost)."""
        with self._lock:
            mem = [e for e in self._events if e.ts_ns > since_ts_ns]
            mem_seqs = {e.seq for e in mem}
            self._subscribers[name] = fn
        if self.persist_dir:
            disk = [
                e
                for e in self._read_persisted(since_ts_ns)
                if e.seq not in mem_seqs
            ]
            snapshot = sorted(disk + mem, key=lambda e: e.seq)
        else:
            snapshot = mem
        for ev in snapshot:
            fn(ev)

    def unsubscribe(self, name: str) -> None:
        with self._lock:
            self._subscribers.pop(name, None)

    def close(self) -> None:
        with self._lock:
            if self._seg_fh is not None:
                self._seg_fh.close()
                self._seg_fh = None
