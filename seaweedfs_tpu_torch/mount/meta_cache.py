"""Local metadata mirror for the mount layer: the port's copy of the JAX
package's ``mount/meta_cache.py``.

Reference: `weed/filesys/meta_cache/` — a local leveldb mirror of filer
entries, lazily filled on first directory visit and kept fresh by the
filer's `SubscribeMetadata` stream so lookups/readdirs never hit the
network twice. Here: sqlite + a polling thread against the filer's
`/_meta/events` feed, started by ``start()``.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Optional

from ..filer.client import FilerClient
from ..util import glog
from ..filer.entry import Entry


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
        self._last_ts_ns = time.time_ns()
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
                r = self.client.meta_events(since_ns=self._last_ts_ns)
            except Exception as e:
                glog.V(2).info("meta_events poll failed: %s", e)
                continue
            for e in r.get("events", ()):
                self._apply(e)
            self._last_ts_ns = r.get("last_ts_ns", self._last_ts_ns)

    def _apply(self, e: dict) -> None:
        old, new = e.get("old_entry"), e.get("new_entry")
        with self._lock:
            if old and (not new or new["full_path"] != old["full_path"]):
                self._db.execute(
                    "DELETE FROM entries WHERE path = ? OR path LIKE ?",
                    (old["full_path"], old["full_path"] + "/%"),
                )
            if new:
                self._insert(new)
            self._db.commit()

    def _insert(self, entry_dict: dict) -> None:
        path = entry_dict["full_path"]
        self._db.execute(
            "INSERT OR REPLACE INTO entries (path, parent, entry) VALUES (?,?,?)",
            (path, _parent(path), json.dumps(entry_dict)),
        )

    # -- lazy fill (meta_cache_init.go ensureVisited) ------------------------
    def _ensure_visited(self, dir_path: str) -> None:
        with self._lock:
            seen = self._db.execute(
                "SELECT 1 FROM visited WHERE dir = ?", (dir_path,)
            ).fetchone()
        if seen:
            return
        try:
            entries = self.client.list(dir_path)
        except Exception:
            return
        with self._lock:
            for d in entries:
                self._insert(d)
            self._db.execute(
                "INSERT OR REPLACE INTO visited (dir) VALUES (?)", (dir_path,)
            )
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
            self._db.commit()
