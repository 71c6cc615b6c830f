"""ReplicationController: one object that owns an active-active pair — the
port's copy of the JAX package's ``replication/controller.py``.

`filer_sync.FilerSync` is a single direction; production active-active is
TWO of them (A→B, B→A) plus the operational machinery neither direction
should own alone:

- a dead-letter queue per direction (`FileQueue`-backed JSONL, fsync'd
  appends) where poison events — the ones bounded retry classified as
  permanently failing — are parked with enough context to replay them
  later;
- lifecycle (start/stop both directions together, survive one side being
  down indefinitely — the loops back off, they don't die);
- the `sync_stats()` aggregate that `/_status` and the `sweed_sync_*`
  gauges read.

A parked record carries the event, the error, and — when the source still
had the bytes at park time — the object content base64-inline, so replay
works even after the source pruned the file. Replay applies through a
fresh `FilerSink` with the original direction's signature so loop
suppression still holds.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from typing import Callable, Optional

from ..util import faultpoints, glog
from .filer_sync import FilerSync
from .notification import FileQueue
from .replicator import Replicator
from .sink import FilerSink


class DeadLetterQueue:
    """Replayable parking lot for poison replication events.

    Backed by the crash-durable `FileQueue` (fsync'd JSONL appends, torn
    trailing line tolerated) — a parked event must survive the same crash
    the sync loop is being hardened against, or "parked" means "dropped
    with extra steps". Replayed records are rewritten (the file is
    compacted to the still-parked remainder) rather than appended-around."""

    def __init__(self, path: str):
        self.path = path
        self._q = FileQueue(path)
        self._lock = threading.Lock()
        self.parked_total = 0
        self.replayed_total = 0

    def park(self, direction: str, source_url: str, target_url: str,
             ev: dict, err: Exception,
             read_content: Optional[Callable] = None) -> None:
        data_b64 = None
        new = ev.get("new_entry")
        if read_content and new and not new.get("is_directory") \
                and new.get("chunks"):
            try:
                data = read_content(new["full_path"])
                if data is not None:
                    data_b64 = base64.b64encode(data).decode()
            except Exception as e:  # noqa: BLE001 — park must not fail on a read
                glog.warning("dlq: content read for %s failed: %s",
                             new.get("full_path"), e)
        faultpoints.fire("repl.dlq.park")
        rec = {
            "direction": direction,
            "source": source_url,
            "target": target_url,
            "ts_ns": ev.get("ts_ns"),
            "path": (new or ev.get("old_entry") or {}).get("full_path"),
            "event": ev,
            "data_b64": data_b64,
            "error": str(err),
            "parked_unix": int(time.time()),
        }
        with self._lock:
            self._q.send(rec["path"] or "", rec)
            self.parked_total += 1

    def entries(self) -> list[dict]:
        with self._lock:
            return [r["message"] for r in self._q.read_all()]

    def depth(self) -> int:
        return len(self.entries())

    def replay(self, apply: Optional[Callable[[dict], None]] = None) -> dict:
        """Re-apply every parked record; records that fail again stay
        parked. Returns {replayed, failed}. `apply` defaults to pushing the
        record's event through a FilerSink at the record's target with the
        original source signature."""
        with self._lock:
            records = [r["message"] for r in self._q.read_all()]
        replayed, still = [], []
        for rec in records:
            try:
                (apply or self._default_apply)(rec)
                replayed.append(rec)
            except Exception as e:  # noqa: BLE001 — one bad record must not block the rest
                rec["error"] = f"replay: {e}"
                still.append(rec)
        with self._lock:
            # compact: rewrite the file as only the still-parked remainder
            with open(self.path, "w") as f:
                for rec in still:
                    f.write(json.dumps(
                        {"key": rec.get("path") or "", "message": rec}
                    ) + "\n")
            self.replayed_total += len(replayed)
        return {"replayed": len(replayed), "failed": len(still)}

    @staticmethod
    def _default_apply(rec: dict) -> None:
        ev = rec["event"]
        sigs = ev.get("signatures") or []
        sink = FilerSink(rec["target"], signatures=sigs or None)
        data = None
        if rec.get("data_b64"):
            data = base64.b64decode(rec["data_b64"])
        repl = Replicator(sink, read_content=lambda _p, _d=data: _d)
        repl.replicate(ev)


# every live controller registers here so sync_stats() (the /_status and
# metrics snapshot) can aggregate without plumbing handles through servers
_ACTIVE: list["ReplicationController"] = []
_ACTIVE_LOCK = threading.Lock()


class ReplicationController:
    """Owns both directions of an active-active filer pair."""

    def __init__(
        self,
        a_url: str,
        b_url: str,
        dlq_dir: str,
        source_path: str = "/",
        poll_interval: float = 0.2,
    ):
        self.a_url, self.b_url = a_url, b_url
        self.dlq_ab = DeadLetterQueue(f"{dlq_dir}/dlq.a_to_b.jsonl")
        self.dlq_ba = DeadLetterQueue(f"{dlq_dir}/dlq.b_to_a.jsonl")
        # active-active needs the IDENTITY path mapping (A:/x/f ↔ B:/x/f):
        # a bare source_path would strip the prefix on the way over and the
        # reverse direction could never find the entry to converge against
        tgt = source_path.rstrip("/")
        self.a_to_b = FilerSync(
            a_url, b_url, source_path=source_path, target_path=tgt,
            poll_interval=poll_interval, direction="a_to_b", dlq=self.dlq_ab,
        )
        self.b_to_a = FilerSync(
            b_url, a_url, source_path=source_path, target_path=tgt,
            poll_interval=poll_interval, direction="b_to_a", dlq=self.dlq_ba,
        )
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)

    def start(self) -> "ReplicationController":
        self.a_to_b.start()
        self.b_to_a.start()
        return self

    def stop(self) -> None:
        self.a_to_b.stop()
        self.b_to_a.stop()
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)

    def stats(self) -> dict:
        out = {}
        for sync, dlq in ((self.a_to_b, self.dlq_ab),
                          (self.b_to_a, self.dlq_ba)):
            s = sync.stats()
            s["dlq_depth"] = dlq.depth()
            s["dlq_parked_total"] = dlq.parked_total
            s["dlq_replayed_total"] = dlq.replayed_total
            out[s["direction"]] = s
        return out


def sync_stats() -> dict:
    """Aggregate snapshot over every live sync direction in this process —
    controllers AND standalone FilerSyncs are not distinguished; directions
    key the dict. Read by filer `/_status` and `register_sync_metrics`."""
    directions: dict = {}
    with _ACTIVE_LOCK:
        ctrls = list(_ACTIVE)
    for c in ctrls:
        directions.update(c.stats())
    totals = {
        k: sum(d.get(k, 0) for d in directions.values())
        for k in ("replicated", "skipped", "redelivered", "lww_skipped",
                  "retries", "parked", "stalls", "inflight", "dlq_depth")
    }
    totals["max_lag_s"] = max(
        [d.get("lag_s", 0.0) for d in directions.values()], default=0.0
    )
    return {"directions": directions, "totals": totals}
