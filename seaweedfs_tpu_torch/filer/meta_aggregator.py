"""MetaAggregator: merged cluster-wide metadata event feed across filer peers.

Mirrors `weed/filer/meta_aggregator.go:31-49` + `meta_replay.go`: every filer
subscribes to each peer's *local* meta stream (HTTP long-poll on
`/_meta/events`, the SubscribeLocalMetadata analog) and republishes into one
aggregated feed that `/_meta/watch` serves to clients. Per-peer resume
offsets are checkpointed in the filer store's KV (meta_aggregator.go:172-208
MetaAggregator offset save/load), so restarts resume where they left off.

Store-sharing detection (meta_aggregator.go:43): each filer writes its
signature into its store's KV at startup; if a peer's signature is already
visible in *our* store, the peer shares it and its events must NOT be
re-applied (they're already in the store) — only fed to watchers. Peers with
independent stores get their events replayed into ours, which is what keeps
N filers over N stores convergent.

The port's copy of the JAX package's ``filer/meta_aggregator.py``.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..util.retry import RetryPolicy, backoff_delays
from .entry import Entry
from .filerstore import FilerStore, NotFoundError
from .meta_log import EventNotification, MetaLog

PEER_SIG_PREFIX = b"filer.peer.sig."
OFFSET_PREFIX = b"meta_agg.offset."

# paces re-polls of an unreachable (or stalling) peer; the follow loop
# itself never gives up — a filer peer being down is a normal state
_FOLLOW_BACKOFF = RetryPolicy(attempts=6, base_s=0.2, cap_s=5.0,
                              deadline_s=1e9, jitter=False)


def apply_event_to_store(store: FilerStore, ev: EventNotification) -> None:
    """Replay one peer mutation into the local store (meta_replay.go:15)."""
    old, new = ev.old_entry, ev.new_entry
    if old and (not new or old.get("full_path") != new.get("full_path")):
        try:
            store.delete_entry(old["full_path"])
        except (NotFoundError, KeyError):
            pass
    if new:
        store.insert_entry(Entry.from_dict(new))  # stores upsert


class MetaAggregator:
    def __init__(
        self,
        filer,
        self_url: str,
        peers: list[str],
        poll_wait_s: float = 8.0,
        feed: Optional[MetaLog] = None,
    ):
        self.filer = filer
        self.self_url = self_url
        self.peers = [p for p in peers if p and p != self_url]
        self.poll_wait_s = poll_wait_s
        # the merged feed is in-memory: it is reconstructible from the peers'
        # persisted logs + our own, exactly like the reference's
        # MetaAggregator.MetaLogBuffer
        self.feed = feed or MetaLog()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MetaAggregator":
        # self events flow straight through
        self.filer.meta_log.subscribe("meta_aggregator", self._on_self_event)
        for peer in self.peers:
            t = threading.Thread(
                target=self._follow_peer, args=(peer,), daemon=True
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self.filer.meta_log.unsubscribe("meta_aggregator")
        for t in self._threads:  # daemon threads; don't block shutdown on a
            t.join(timeout=0.2)  # long-poll that's still in flight

    def _on_self_event(self, ev: EventNotification) -> None:
        # the feed RE-STAMPS with local receive time (the reference does the
        # same when republishing): watch cursors are ts-based, so carrying a
        # peer's older origin ts would make late-arriving peer events sort
        # behind a cursor already advanced by our own events — lost forever
        self.feed.append(
            ev.directory,
            ev.old_entry,
            ev.new_entry,
            delete_chunks=ev.delete_chunks,
            signatures=ev.signatures,
            is_from_other_cluster=ev.is_from_other_cluster,
        )

    # -- peer following ------------------------------------------------------
    def _peer_shares_store(self, peer_signature: int) -> bool:
        return (
            self.filer.store.kv_get(
                PEER_SIG_PREFIX + str(peer_signature).encode()
            )
            is not None
        )

    def _offset_key(self, peer: str) -> bytes:
        return OFFSET_PREFIX + peer.encode()

    _MAX_APPLY_RETRIES = 5

    def _follow_peer(self, peer: str) -> None:
        from ..server.http_util import http_json

        store = self.filer.store
        shares_store: Optional[bool] = None
        since = int(store.kv_get(self._offset_key(peer)) or 0)
        delays = None  # lazily-made backoff_delays generator; None = healthy
        apply_failures: dict[int, int] = {}  # peer seq -> consecutive failures
        while not self._stop.is_set():
            try:
                if shares_store is None:
                    status = http_json("GET", f"http://{peer}/_status")
                    shares_store = self._peer_shares_store(
                        int(status.get("signature", 0))
                    )
                r = http_json(
                    "GET",
                    f"http://{peer}/_meta/events?since_ns={since}"
                    f"&wait_s={self.poll_wait_s}&limit=500",
                    timeout=self.poll_wait_s + 10,
                )
                delays = None  # a successful poll resets the schedule
            except Exception:
                shares_store = None  # peer may have restarted with a new store
                if delays is None:
                    delays = backoff_delays(_FOLLOW_BACKOFF)
                if self._stop.wait(next(delays, _FOLLOW_BACKOFF.cap_s)):
                    return
                continue
            oldest = int(r.get("oldest_ts_ns", 0))
            if since and oldest > since:
                # gap: peer pruned history past our offset — resync from the
                # start of what it still has (upserts make replay idempotent)
                since = 0
            events = r.get("events", [])
            applied_any = False
            stalled = False
            for d in events:
                ev = EventNotification.from_dict(d)
                if shares_store is False:
                    try:
                        apply_event_to_store(store, ev)
                        apply_failures.pop(ev.seq, None)
                    except Exception:
                        # do NOT advance past an unapplied event — that is
                        # silent store divergence. Retry it on the next poll
                        # (transient store errors heal); a poison event is
                        # skipped after _MAX_APPLY_RETRIES so one bad record
                        # can't stall the whole peer stream.
                        n = apply_failures.get(ev.seq, 0) + 1
                        apply_failures[ev.seq] = n
                        if n <= self._MAX_APPLY_RETRIES:
                            stalled = True
                            break
                        apply_failures.pop(ev.seq, None)
                self.feed.append(
                    ev.directory,
                    ev.old_entry,
                    ev.new_entry,
                    delete_chunks=ev.delete_chunks,
                    signatures=ev.signatures,
                    is_from_other_cluster=ev.is_from_other_cluster,
                )
                since = max(since, ev.ts_ns)
                applied_any = True
            if applied_any:
                store.kv_put(self._offset_key(peer), str(since).encode())
            if stalled:
                if delays is None:
                    delays = backoff_delays(_FOLLOW_BACKOFF)
                if self._stop.wait(next(delays, _FOLLOW_BACKOFF.cap_s)):
                    return
