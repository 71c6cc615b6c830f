"""Local-directory synchronization over the filer — the mount daemon. The
port's copy of the JAX package's ``mount/sync.py``.

Reference: `weed/command/mount_std.go` exposes the filer through FUSE; the
same continuous view without FUSE is a bidirectional synchronizer: remote
metadata events (the stream that keeps the reference's meta_cache fresh)
are applied to a local directory, and local modifications (mtime/size
scan) are written back through WFS. `weed filer.copy`
(command/filer_copy.go) is the one-shot upload variant. The state file
(``.weed_mount_state.json``) is the JAX package's format.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from ..filer.client import FilerClient
from ..util import glog
from .wfs import WFS


def copy_to_filer(
    local_dir: str,
    filer_url: str,
    dest_dir: str = "/",
    chunk_size: int = 8 * 1024 * 1024,
) -> int:
    """Upload a local tree (weed filer.copy). Returns files copied."""
    wfs = WFS(filer_url, chunk_size=chunk_size, use_meta_cache=False)
    count = 0
    try:
        dest_dir = "/" + dest_dir.strip("/")
        for root, dirs, files in os.walk(local_dir):
            rel = os.path.relpath(root, local_dir)
            remote_root = (
                dest_dir if rel == "." else f"{dest_dir.rstrip('/')}/{rel}"
            ).replace("//", "/")
            for d in dirs:
                wfs.mkdir(f"{remote_root.rstrip('/')}/{d}")
            for name in files:
                src = os.path.join(root, name)
                with open(src, "rb") as f, wfs.open(
                    f"{remote_root.rstrip('/')}/{name}", "w"
                ) as out:
                    off = 0
                    while True:
                        piece = f.read(chunk_size)
                        if not piece:
                            break
                        out.write(off, piece)
                        off += len(piece)
                count += 1
        return count
    finally:
        wfs.close()


def copy_from_filer(
    filer_url: str, src_dir: str, local_dir: str, chunk_size: int = 8 * 1024 * 1024
) -> int:
    """Materialize a filer tree locally. Returns files copied."""
    wfs = WFS(filer_url, chunk_size=chunk_size, use_meta_cache=False)
    count = 0
    try:
        def walk(remote: str, local: str):
            nonlocal count
            os.makedirs(local, exist_ok=True)
            for e in wfs.listdir(remote):
                lpath = os.path.join(local, e.name)
                if e.is_directory:
                    walk(e.full_path, lpath)
                else:
                    with wfs.open(e.full_path, "r") as f, open(lpath, "wb") as out:
                        off, size = 0, f.size()
                        while off < size:
                            piece = f.read(off, min(chunk_size, size - off))
                            if not piece:
                                break
                            out.write(piece)
                            off += len(piece)
                    count += 1

        walk("/" + src_dir.strip("/"), local_dir)
        return count
    finally:
        wfs.close()


class MountSync:
    """Continuous bidirectional sync between a local dir and a filer dir.

    Remote→local rides the filer metadata event feed; local→remote is an
    mtime/size scan. A state file records (mtime, size) per path at the
    last sync so each side only pushes genuine changes (and remote events
    caused by our own uploads are recognized and skipped).
    """

    def __init__(
        self,
        filer_url: str,
        remote_dir: str,
        local_dir: str,
        scan_seconds: float = 1.0,
    ):
        self.client = FilerClient(filer_url)
        self.wfs = WFS(filer_url, use_meta_cache=False)
        self.remote_dir = "/" + remote_dir.strip("/")
        self.local_dir = local_dir
        self.scan_seconds = scan_seconds
        self._state_path = os.path.join(local_dir, ".weed_mount_state.json")
        self._state: dict[str, list] = {}
        self._last_ts_ns = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MountSync":
        os.makedirs(self.local_dir, exist_ok=True)
        if os.path.exists(self._state_path):
            with open(self._state_path) as f:
                saved = json.load(f)
            self._state = saved.get("state", {})
            self._last_ts_ns = saved.get("last_ts_ns", 0)
        else:
            self._last_ts_ns = time.time_ns()
            copy_from_filer(
                self.client.base.split("//", 1)[1],
                self.remote_dir,
                self.local_dir,
            )
            for rel, st in self._scan_local().items():
                self._state[rel] = st
        self._save_state()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5.0)
        self.wfs.close()

    def _save_state(self) -> None:
        with open(self._state_path, "w") as f:
            json.dump({"state": self._state, "last_ts_ns": self._last_ts_ns}, f)

    # -- helpers -------------------------------------------------------------
    def _rel_of_remote(self, full_path: str) -> Optional[str]:
        prefix = self.remote_dir.rstrip("/") + "/"
        if self.remote_dir == "/":
            prefix = "/"
        if not full_path.startswith(prefix):
            return None
        return full_path[len(prefix) :]

    def _remote_of_rel(self, rel: str) -> str:
        return f"{self.remote_dir.rstrip('/')}/{rel}".replace("//", "/")

    def _scan_local(self) -> dict[str, list]:
        out = {}
        for root, _dirs, files in os.walk(self.local_dir):
            for name in files:
                if name == ".weed_mount_state.json":
                    continue
                p = os.path.join(root, name)
                rel = os.path.relpath(p, self.local_dir)
                st = os.stat(p)
                out[rel] = [st.st_mtime, st.st_size]
        return out

    # -- the sync loop -------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.scan_seconds):
            try:
                self.sync_once()
            except Exception as e:
                glog.V(1).info("sync pass failed: %s", e)
                continue

    def sync_once(self) -> dict:
        pulled = self._apply_remote_events()
        pushed = self._push_local_changes()
        self._save_state()
        return {"pulled": pulled, "pushed": pushed}

    @staticmethod
    def _remote_version(entry_dict: dict) -> int:
        """ns-resolution change marker for a remote entry: the newest chunk
        mtime, falling back to the (second-resolution) entry mtime."""
        return max(
            (c.get("mtime", 0) for c in entry_dict.get("chunks", [])),
            default=entry_dict.get("mtime", 0) * 1_000_000_000,
        )

    def _apply_remote_events(self) -> int:
        r = self.client.meta_events(since_ns=self._last_ts_ns)
        applied = 0
        for e in r.get("events", ()):
            # one bad event (e.g. create of an already-deleted file) must not
            # wedge the feed: apply best-effort, always advance past it
            try:
                applied += self._apply_one_remote_event(e)
            except Exception as e:
                glog.V(2).info("remote event skipped: %s", e)
        self._last_ts_ns = r.get("last_ts_ns", self._last_ts_ns)
        return applied

    def _apply_one_remote_event(self, e: dict) -> int:
        applied = 0
        old, new = e.get("old_entry"), e.get("new_entry")
        if old and (not new or new["full_path"] != old["full_path"]):
            rel = self._rel_of_remote(old["full_path"])
            if rel is not None:
                lp = os.path.join(self.local_dir, rel)
                if os.path.isfile(lp):
                    os.unlink(lp)
                    self._state.pop(rel, None)
                    applied += 1
        if new and not new.get("is_directory"):
            rel = self._rel_of_remote(new["full_path"])
            if rel is None:
                return applied
            lp = os.path.join(self.local_dir, rel)
            # skip events at or before the remote version we already hold
            # (echoes of our own pushes, or replays)
            known = self._state.get(rel)
            version = self._remote_version(new)
            if (
                known
                and len(known) >= 3
                and os.path.exists(lp)
                and version <= known[2]
            ):
                return applied
            os.makedirs(os.path.dirname(lp) or ".", exist_ok=True)
            with self.wfs.open(new["full_path"], "r") as f, open(lp, "wb") as out:
                off, total = 0, f.size()
                while off < total:
                    piece = f.read(off, min(4 * 1024 * 1024, total - off))
                    if not piece:
                        break
                    out.write(piece)
                    off += len(piece)
            st = os.stat(lp)
            self._state[rel] = [st.st_mtime, st.st_size, version]
            applied += 1
        return applied

    def _push_local_changes(self) -> int:
        now = self._scan_local()
        pushed = 0
        for rel, st in now.items():
            known = self._state.get(rel)
            if known and known[:2] == st:
                continue
            lp = os.path.join(self.local_dir, rel)
            remote = self._remote_of_rel(rel)
            with open(lp, "rb") as f, self.wfs.open(remote, "w") as out:
                off = 0
                while True:
                    piece = f.read(4 * 1024 * 1024)
                    if not piece:
                        break
                    out.write(off, piece)
                    off += len(piece)
            # record the remote version our push produced so its event
            # echo is recognized and skipped
            d = self.client.get_entry(remote)
            version = self._remote_version(d) if d else 0
            self._state[rel] = [st[0], st[1], version]
            pushed += 1
        for rel in list(self._state):
            if rel not in now:
                # local deletion → remote deletion
                self.client.delete(self._remote_of_rel(rel))
                self._state.pop(rel, None)
                pushed += 1
        return pushed
