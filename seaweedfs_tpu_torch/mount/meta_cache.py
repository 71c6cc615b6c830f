"""Local metadata mirror for the mount layer: the port's copy of the JAX
package's ``mount/meta_cache.py``.

Reference: `weed/filesys/meta_cache/` — a local leveldb mirror of filer
entries, lazily filled on first directory visit and kept fresh by the
filer's `SubscribeMetadata` stream so lookups/readdirs never hit the
network twice. Here: sqlite + a polling thread against the filer's
`/_meta/events` feed, started by ``start()``; ``poll_once()`` is one poll.

Unlike the JAX package's copy, a directory's listing is authoritative as of
the feed's high-water mark read just before it was taken: an event at or
before that mark is already in the listing, so it changes nothing under
that directory (each side of a rename is judged by its own directory's
mark) and counts in ``stale_dropped``. Replaying such an event would bring
back an entry the listing saw removed. A poll reads the feed up to its head
and applies that batch under one hold of the lock, so a reader never sees
half of it. No poll reads the feed between a listing's mark and the listing
(``_Gate``): a batch read there could hold an event after the mark that the
listing already undid, and would replay it over the listing.
"""

from __future__ import annotations

import contextlib
import json
import sqlite3
import threading
import time
from typing import Optional

from ..filer.client import FilerClient
from ..util import glog
from ..filer.entry import Entry

_PAGE = 1000  # entries of a listing page, events of a feed page


def read_feed(client: FilerClient, since_ns: int) -> tuple[list, int]:
    """Every event of the filer's ``/_meta/events`` feed after ``since_ns``,
    page by page, and the feed's head: the last one's timestamp
    (``since_ns`` when there is none)."""
    events, head = [], since_ns
    while True:
        r = client.meta_events(since_ns=head, limit=_PAGE)
        page = r.get("events", ())
        events += page
        head = max(head, r.get("last_ts_ns", 0))
        if len(page) < _PAGE:
            return events, head


class _Gate:
    """Shared by directory fills and held alone by a poll, so that no poll
    reads the feed between a fill's mark and its listing. A waiting poll
    goes before the fills that come after it."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._fills = 0
        self._polls = 0  # waiting or running
        self._polling = False

    @contextlib.contextmanager
    def fill(self):
        with self._cond:
            self._cond.wait_for(lambda: not self._polls)
            self._fills += 1
        try:
            yield
        finally:
            with self._cond:
                self._fills -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def poll(self):
        with self._cond:
            self._polls += 1
            self._cond.wait_for(lambda: not (self._polling or self._fills))
            self._polling = True
        try:
            yield
        finally:
            with self._cond:
                self._polls -= 1
                self._polling = False
                self._cond.notify_all()


def _parent(path: str) -> str:
    if path == "/":
        return "/"
    p = path.rsplit("/", 1)[0]
    return p or "/"


class MetaCache:
    def __init__(self, filer_url: str, db_path: str = ":memory:"):
        self.client = FilerClient(filer_url)
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS entries ("
            " path TEXT PRIMARY KEY, parent TEXT, entry TEXT)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS visited (dir TEXT PRIMARY KEY)"
        )
        self._db.execute("CREATE INDEX IF NOT EXISTS by_parent ON entries(parent)")
        self._lock = threading.Lock()
        self._gate = _Gate()
        self._last_ts_ns = time.time_ns()
        self._marks: dict[str, int] = {}  # visited dir -> its listing's mark
        self.stale_dropped = 0  # event sides older than their dir's listing
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- subscription (meta_cache_subscription.go) ---------------------------
    def start(self, poll_seconds: float = 0.5) -> "MetaCache":
        self._thread = threading.Thread(
            target=self._follow, args=(poll_seconds,), daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
        self._db.close()

    def _follow(self, poll_seconds: float) -> None:
        while not self._stop.wait(poll_seconds):
            try:
                self.poll_once()
            except Exception as e:
                glog.V(2).info("meta_events poll failed: %s", e)

    def poll_once(self) -> int:
        """Apply every event since the last poll, up to the feed's head, as
        one batch; returns how many there were."""
        with self._gate.poll():
            events, head = read_feed(self.client, self._last_ts_ns)
            with self._lock:
                for e in events:
                    self._apply(e)
                self._last_ts_ns = head
                self._db.commit()
        return len(events)

    def _fresher(self, dir_path: str, ts_ns: int) -> bool:
        """Whether ``dir_path``'s listing already holds an event of ``ts_ns``."""
        return self._marks.get(dir_path, -1) >= ts_ns

    def _apply(self, e: dict) -> None:
        ts, old, new = e["ts_ns"], e.get("old_entry"), e.get("new_entry")
        if old and (not new or new["full_path"] != old["full_path"]):
            if self._fresher(_parent(old["full_path"]), ts):
                self.stale_dropped += 1
            else:
                self._forget(old["full_path"], ts)
        if new:
            if self._fresher(_parent(new["full_path"]), ts):
                self.stale_dropped += 1
            else:
                self._insert(new)

    def _forget(self, path: str, ts_ns: int) -> None:
        """Drop ``path`` and what lies under it, but for the entries of
        directories listed after ``ts_ns``."""
        fresh = [d for d, m in self._marks.items()
                 if m >= ts_ns and (d == path or d.startswith(path + "/"))]
        self._db.execute(
            "DELETE FROM entries WHERE path = ? OR (path LIKE ? AND parent NOT IN "
            f"({','.join('?' * len(fresh))}))",
            (path, path + "/%", *fresh),
        )

    def _insert(self, entry_dict: dict) -> None:
        path = entry_dict["full_path"]
        self._db.execute(
            "INSERT OR REPLACE INTO entries (path, parent, entry) VALUES (?,?,?)",
            (path, _parent(path), json.dumps(entry_dict)),
        )

    def _feed_head(self) -> int:
        """The filer's event high-water mark. The filer logs an event after
        its store holds the change, so a listing taken after this read
        holds every event at or before it."""
        return read_feed(self.client, self._last_ts_ns)[1]

    def _list_all(self, dir_path: str) -> list[dict]:
        entries: list[dict] = []
        last = ""
        while True:
            page = self.client.list(dir_path, start_after=last, limit=_PAGE)
            entries += page
            if len(page) < _PAGE:
                return entries
            last = page[-1]["full_path"].rsplit("/", 1)[-1]

    # -- lazy fill (meta_cache_init.go ensureVisited) ------------------------
    def _visited(self, dir_path: str) -> bool:
        with self._lock:
            return bool(self._db.execute(
                "SELECT 1 FROM visited WHERE dir = ?", (dir_path,)
            ).fetchone())

    def _ensure_visited(self, dir_path: str) -> None:
        if self._visited(dir_path):
            return
        with self._gate.fill():
            try:
                mark = self._feed_head()
                entries = self._list_all(dir_path)
            except Exception:
                return
            with self._lock:
                if self._db.execute(
                    "SELECT 1 FROM visited WHERE dir = ?", (dir_path,)
                ).fetchone():
                    return  # filled by another thread meanwhile: no poll since
                # the listing replaces what events put there before it
                self._db.execute("DELETE FROM entries WHERE parent = ?", (dir_path,))
                for d in entries:
                    self._insert(d)
                self._db.execute(
                    "INSERT OR REPLACE INTO visited (dir) VALUES (?)", (dir_path,)
                )
                self._marks[dir_path] = mark
                self._db.commit()

    # -- lookups -------------------------------------------------------------
    def lookup(self, path: str) -> Optional[Entry]:
        path = path.rstrip("/") or "/"
        self._ensure_visited(_parent(path))
        with self._lock:
            row = self._db.execute(
                "SELECT entry FROM entries WHERE path = ?", (path,)
            ).fetchone()
            parent_visited = bool(
                self._db.execute(
                    "SELECT 1 FROM visited WHERE dir = ?", (_parent(path),)
                ).fetchone()
            )
        if row:
            return Entry.from_dict(json.loads(row[0]))
        if parent_visited:
            # the cached listing is authoritative: a miss is a real miss —
            # no per-negative-lookup filer round-trip
            return None
        # fall back to the filer (root, or parents whose listing failed)
        d = self.client.get_entry(path)
        if d is None:
            return None
        with self._lock:
            self._insert(d)
            self._db.commit()
        return Entry.from_dict(d)

    def list_dir(self, dir_path: str) -> list[Entry]:
        dir_path = dir_path.rstrip("/") or "/"
        self._ensure_visited(dir_path)
        with self._lock:
            rows = self._db.execute(
                "SELECT entry FROM entries WHERE parent = ? ORDER BY path",
                (dir_path,),
            ).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def invalidate(self, path: str) -> None:
        path = path.rstrip("/") or "/"
        with self._lock:
            self._db.execute(
                "DELETE FROM entries WHERE path = ? OR path LIKE ?",
                (path, path + "/%"),
            )
            # drop the listing markers too: the parent's cached listing no
            # longer authoritatively covers this path
            self._db.execute(
                "DELETE FROM visited WHERE dir IN (?, ?)", (path, _parent(path))
            )
            self._marks.pop(path, None)
            self._marks.pop(_parent(path), None)
            self._db.commit()
