"""Needle-id sequencers (weed/sequence/sequence.go + memory_sequencer.go)."""

from __future__ import annotations
from ..util.locks import make_lock



class MemorySequencer:
    """Monotonic batch allocator. Persistence is the caller's: heartbeats
    report each server's largest key and ``set_max`` moves past it."""

    def __init__(self, start: int = 1):
        self._counter = max(1, start)
        self._lock = make_lock("MemorySequencer._lock")

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen > self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class EtcdSequencer:
    """Cluster-shared needle-id allocator over etcd, the reference's optional
    ``-master.sequencer=etcd`` (weed/sequence/etcd_sequencer.go:45): batches
    are reserved with a compare-and-swap on one counter key, so independent
    masters can allocate without a leader.

    Raises ImportError without the 'etcd3' package (MemorySequencer is the
    default)."""

    KEY = "seaweedfs.master.sequence"
    BATCH = 1000  # ids reserved per CAS round-trip (etcd_sequencer.go:20)

    def __init__(self, endpoint: str = "127.0.0.1:2379"):
        try:
            import etcd3  # type: ignore
        except ImportError as e:
            raise ImportError(
                "EtcdSequencer needs the 'etcd3' package; the in-memory "
                "sequencer is the default"
            ) from e
        host, _, port = endpoint.partition(":")
        self._c = etcd3.client(host=host, port=int(port or 2379))
        self._lock = make_lock("EtcdSequencer._lock")
        self._next = 0  # local cursor within the reserved batch
        self._ceiling = 0

    def _reserve(self, at_least: int, need: int = 0) -> None:
        """Called with ``_lock`` held."""
        while True:
            raw, _ = self._c.get(self.KEY)
            cur = int(raw) if raw else 1
            # one assign may ask for more ids than a batch: reserve enough
            # that the whole request fits inside the CAS'd window, or two
            # masters would hand out overlapping ranges
            want = max(cur, at_least) + max(self.BATCH, need)
            ok = (
                self._c.transactions is not None
                and self._c.transaction(
                    compare=[self._c.transactions.value(self.KEY) == (raw or b"")]
                    if raw else [self._c.transactions.version(self.KEY) == 0],
                    success=[self._c.transactions.put(self.KEY, str(want))],
                    failure=[],
                )[0]
            )
            if ok:
                # sweedlint: ok lock-discipline called with self._lock held by next_file_id/set_max
                self._next, self._ceiling = max(cur, at_least), want
                return

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            if self._next + count > self._ceiling:
                self._reserve(self._next, need=count)
            start = self._next
            self._next += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen >= self._ceiling:
                self._reserve(seen + 1)
            elif seen >= self._next:
                self._next = seen + 1

    def peek(self) -> int:
        with self._lock:
            return self._next
