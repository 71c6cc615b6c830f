"""Replicator: meta event → sink call, the port's copy of the JAX package's
``replication/replicator.py`` (reference `replication/replicator.go:22`).

An event is {directory, old_entry, new_entry}:
  old=None,  new=entry → create
  old=entry, new=None  → delete
  both set, same path  → update
  both set, diff path  → rename = delete old + create new
Events outside `source_path` are ignored (replicator.go:35).
"""

from __future__ import annotations

from typing import Callable, Optional

ReadContent = Callable[[str], Optional[bytes]]


class Replicator:
    def __init__(
        self,
        sink,
        read_content: ReadContent,
        source_path: str = "/",
        exclude_signature: int = 0,
    ):
        self.sink = sink
        self.read_content = read_content
        self.source_path = source_path.rstrip("/") or "/"
        self.exclude_signature = exclude_signature
        self.replicated = 0
        self.skipped = 0

    def _in_scope(self, path: str) -> bool:
        if self.source_path == "/":
            return True
        return path == self.source_path or path.startswith(self.source_path + "/")

    def _key(self, path: str) -> str:
        if self.source_path == "/":
            return path
        return path[len(self.source_path) :] or "/"

    def replicate(self, event: dict) -> bool:
        """Apply one event; returns True if it caused a sink write."""
        if self.exclude_signature and self.exclude_signature in event.get(
            "signatures", []
        ):
            self.skipped += 1
            return False  # originated at (or already passed through) the target
        old, new = event.get("old_entry"), event.get("new_entry")
        old_path = old.get("full_path") if old else None
        new_path = new.get("full_path") if new else None
        did = False
        if old and not self._in_scope(old_path):
            old, old_path = None, None
        if new and not self._in_scope(new_path):
            new, new_path = None, None
        if old and (not new or new_path != old_path):
            self.sink.delete_entry(
                self._key(old_path), old.get("is_directory", False)
            )
            did = True
        if new:
            data = None
            if not new.get("is_directory") and new.get("chunks"):
                data = self.read_content(new_path)
            if old and new_path == old_path:
                self.sink.update_entry(self._key(new_path), new, data)
            else:
                self.sink.create_entry(self._key(new_path), new, data)
            did = True
        if did:
            self.replicated += 1
        else:
            self.skipped += 1
        return did
