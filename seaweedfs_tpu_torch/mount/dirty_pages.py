"""Dirty-page interval buffering for mounted file writes: the port's copy of
the JAX package's ``mount/dirty_pages.py``.

Reference: `weed/filesys/dirty_page_interval.go` (ContinuousIntervals:
overlapping writes are clipped against existing intervals, adjacent ones
merged) and `dirty_pages.go` (flush when a continuous run reaches the
chunk size). Random writes at arbitrary offsets coalesce into the fewest
possible upload chunks.
"""

from __future__ import annotations

from typing import Optional


class Interval:
    __slots__ = ("start", "data", "ts_ns")

    def __init__(self, start: int, data: bytes, ts_ns: int = 0):
        self.start = start
        self.data = data
        self.ts_ns = ts_ns

    @property
    def stop(self) -> int:
        return self.start + len(self.data)

    def __repr__(self):
        return f"Interval({self.start}..{self.stop})"


class ContinuousIntervals:
    """Sorted, non-overlapping dirty byte ranges of one open file."""

    def __init__(self):
        self.intervals: list[Interval] = []

    def total_size(self) -> int:
        return sum(len(i.data) for i in self.intervals)

    def add_interval(self, offset: int, data: bytes, ts_ns: int = 0) -> None:
        """Newest write wins; older intervals are clipped around it
        (dirty_page_interval.go AddInterval)."""
        if not data:
            return
        new = Interval(offset, bytes(data), ts_ns)
        out: list[Interval] = []
        for iv in self.intervals:
            if iv.stop <= new.start or iv.start >= new.stop:
                out.append(iv)
                continue
            # clip the old interval against the new one
            if iv.start < new.start:
                out.append(Interval(iv.start, iv.data[: new.start - iv.start], iv.ts_ns))
            if iv.stop > new.stop:
                out.append(Interval(new.stop, iv.data[new.stop - iv.start :], iv.ts_ns))
        out.append(new)
        out.sort(key=lambda i: i.start)
        # merge adjacent runs so flush produces the fewest chunks
        merged: list[Interval] = []
        for iv in out:
            if merged and merged[-1].stop == iv.start:
                prev = merged[-1]
                merged[-1] = Interval(
                    prev.start, prev.data + iv.data, max(prev.ts_ns, iv.ts_ns)
                )
            else:
                merged.append(iv)
        self.intervals = merged

    def read_data_at(self, offset: int, size: int) -> list[tuple[int, bytes]]:
        """Dirty bytes overlapping [offset, offset+size) as
        (absolute_offset, data) pairs."""
        out = []
        stop = offset + size
        for iv in self.intervals:
            if iv.stop <= offset or iv.start >= stop:
                continue
            lo = max(iv.start, offset)
            hi = min(iv.stop, stop)
            out.append((lo, iv.data[lo - iv.start : hi - iv.start]))
        return out

    def pop_all(self) -> list[Interval]:
        ivs, self.intervals = self.intervals, []
        return ivs

    def max_stop(self) -> int:
        return max((i.stop for i in self.intervals), default=0)

    def pop_largest_if_over(self, limit: int) -> Optional[Interval]:
        """Detach the largest continuous run if it has reached `limit`
        (eager flush of full chunks, dirty_pages.go saveExistingLargestPageToStorage)."""
        if not self.intervals:
            return None
        largest = max(self.intervals, key=lambda i: len(i.data))
        if len(largest.data) < limit:
            return None
        self.intervals.remove(largest)
        return largest
