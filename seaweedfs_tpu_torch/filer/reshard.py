"""Subtree-ownership reshard: move a directory subtree between filers so
ring-membership changes converge, surviving a crash at ANY step. The port's
copy of the JAX package's ``filer/reshard.py``; its marker and checkpoint
keys are the JAX package's, so either package's filer resumes the other's
move.

It is filer.sync's discipline (``replication/filer_sync.py``: idempotence
markers + durable offset checkpoints) re-aimed at metadata migration:

1. deterministic DFS (preorder, children sorted by name — the store's
   listing order) over the subtree on the SOURCE filer;
2. per-entry idempotence marker ``reshard.applied.<epoch>.<sha1(path)>``
   written to the TARGET's KV *after* the entry lands there — a replayed
   apply sees the marker and skips, so a crashed run re-driven from the
   top never duplicates an entry;
3. a durable prefix checkpoint (every ``ckpt_every`` applies) recording
   the last applied path, so resumption skips whole already-copied
   subtrees without even paying the marker round-trips;
4. a ``done`` marker once the copy is complete — the purge below never
   runs before it, so a crash window can leave the subtree on both
   filers (harmless: ring ownership already points at the target) but
   never on neither;
5. metadata-only purge of the source subtree (``skipChunkPurge`` — the
   chunks on volume servers are shared by both copies; fids never
   change, which is why resharding is cheap);
6. marker GC by walking the TARGET subtree (markers are only ever
   written for entries that exist there, so the walk enumerates them
   exactly), then dropping checkpoint and done marker.

Faultpoints (``reshard.apply``, ``reshard.checkpoint``,
``reshard.done``, ``reshard.purge``) arm the kill windows the chaos
matrix drives: kill the filer at each, restart, re-drive the reshard,
and the tree hash must converge with zero dupes or drops.
"""

from __future__ import annotations

import hashlib
import urllib.parse
from typing import Optional

from ..util import faultpoints, glog
from .client import FilerClient


def _sha1(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()


class _InternalFilerClient(FilerClient):
    """FilerClient whose every request carries ``noRedirect=1``: reshard
    traffic must hit the addressed filer itself — the source still holds
    entries the ring says belong elsewhere, and the target receives
    entries before it would pass its own ownership check."""

    def _u(self, path: str, **q) -> str:
        q.setdefault("noRedirect", "1")
        qs = urllib.parse.urlencode({k: v for k, v in q.items() if v != ""})
        return self.base + urllib.parse.quote(path) + ("?" + qs if qs else "")


class Resharder:
    """One subtree move, re-drivable until it reports done."""

    def __init__(self, source_url: str, target_url: str, root: str,
                 epoch: str, ckpt_every: int = 32):
        self.root = "/" + root.strip("/")
        self.epoch = str(epoch)
        self.src = _InternalFilerClient(source_url, retry_reads=True)
        self.dst = _InternalFilerClient(target_url, retry_reads=True)
        self.ckpt_every = max(1, ckpt_every)
        self._since_ckpt = 0
        self.applied = 0
        self.marker_skips = 0
        self.ckpt_skips = 0
        self.resumed_from = ""

    # marker / checkpoint keys ------------------------------------------------
    def _mkey(self, path: str) -> str:
        return f"reshard.applied.{self.epoch}.{_sha1(path)}"

    @property
    def _ckpt_key(self) -> str:
        return f"reshard.ckpt.{self.epoch}.{_sha1(self.root)}"

    @property
    def _done_key(self) -> str:
        return f"reshard.done.{self.epoch}.{_sha1(self.root)}"

    # protocol ----------------------------------------------------------------
    def run(self) -> dict:
        """Drive the move to completion from whatever state a previous
        (possibly killed) run left behind."""
        ckpt = self.dst.kv_get(self._ckpt_key)
        self.resumed_from = ckpt.decode() if ckpt else ""
        if self.dst.kv_get(self._done_key) is None:
            root_entry = self.src.get_entry(self.root)
            if root_entry is None:
                # source subtree already purged by a prior run that died
                # between purge and GC — nothing to copy
                glog.info("reshard %s: source empty, copy already complete",
                          self.root)
            else:
                self._apply(self.root, root_entry)
                self._walk(self.root)
            self.dst.kv_put(self._done_key, b"1")
            faultpoints.fire("reshard.done")
        # copy durable; everything below is idempotent cleanup
        self.src.delete(self.root, recursive=True, skip_chunk_purge=True)
        faultpoints.fire("reshard.purge")
        self._gc_markers()
        return {
            "root": self.root, "epoch": self.epoch,
            "applied": self.applied, "marker_skips": self.marker_skips,
            "ckpt_skips": self.ckpt_skips, "resumed_from": self.resumed_from,
        }

    def _walk(self, dir_path: str) -> None:
        cursor = ""
        while True:
            page = self.src.list(dir_path, start_after=cursor, limit=1000)
            if not page:
                break
            for e in page:
                cursor = e["name"]
                path = f"{dir_path.rstrip('/')}/{e['name']}"
                if self._skip_by_ckpt(path):
                    self.ckpt_skips += 1
                    continue
                if not self._is_ckpt_ancestor(path):
                    self._apply(path, e)
                if e.get("is_directory"):
                    self._walk(path)
            if len(page) < 1000:
                break

    def _skip_by_ckpt(self, path: str) -> bool:
        """True when the checkpoint proves ``path`` AND its whole subtree
        are already applied. In preorder-with-sorted-children, a subtree
        occupies a contiguous path-string range: if ``path`` sorts before
        the checkpoint and the checkpoint is NOT inside the subtree, then
        every subtree path sorts before the checkpoint too."""
        ck = self.resumed_from
        return bool(ck) and path < ck and not ck.startswith(path + "/")

    def _is_ckpt_ancestor(self, path: str) -> bool:
        """Ancestors of the checkpoint path were applied before it was
        written (preorder); recurse into them but skip the re-apply."""
        ck = self.resumed_from
        return bool(ck) and (path == ck or ck.startswith(path + "/"))

    def _apply(self, path: str, entry: dict) -> None:
        key = self._mkey(path)
        if self.dst.kv_get(key) is not None:
            self.marker_skips += 1
            return
        entry = dict(entry)
        entry["full_path"] = path
        entry.pop("name", None)
        self.dst.create_entry(path, entry)
        # marker AFTER the entry: a crash between them re-applies the
        # same bytes (idempotent), the reverse order could drop the entry
        self.dst.kv_put(key, b"1")
        faultpoints.fire("reshard.apply", path=path)
        self.applied += 1
        self._since_ckpt += 1
        if self._since_ckpt >= self.ckpt_every:
            self._since_ckpt = 0
            self.dst.kv_put(self._ckpt_key, path.encode())
            faultpoints.fire("reshard.checkpoint")

    def _gc_markers(self) -> None:
        """Markers exist only for entries present on the target, so a
        target-side walk enumerates every one; the done marker goes last
        so a crash mid-GC resumes as idempotent cleanup."""
        stack = [self.root]
        while stack:
            d = stack.pop()
            self.dst.kv_delete(self._mkey(d))
            e = self.dst.get_entry(d)
            if e is None or not e.get("is_directory"):
                continue
            cursor = ""
            while True:
                page = self.dst.list(d, start_after=cursor, limit=1000)
                if not page:
                    break
                for c in page:
                    cursor = c["name"]
                    child = f"{d.rstrip('/')}/{c['name']}"
                    if c.get("is_directory"):
                        stack.append(child)
                    else:
                        self.dst.kv_delete(self._mkey(child))
                if len(page) < 1000:
                    break
        self.dst.kv_delete(self._ckpt_key)
        self.dst.kv_delete(self._done_key)


def tree_hash(filer_url: str, root: str) -> str:
    """Order-independent content hash of a subtree's metadata, computed
    through the addressed filer (noRedirect, so fleet members can be
    hashed individually). Two filers agree iff they hold byte-identical
    trees — the chaos matrix's convergence oracle."""
    c = _InternalFilerClient(filer_url, retry_reads=True)
    h = hashlib.sha256()
    stack = ["/" + root.strip("/")]
    lines = []
    while stack:
        d = stack.pop()
        cursor = ""
        while True:
            page = c.list(d, start_after=cursor, limit=1000)
            if not page:
                break
            for e in page:
                cursor = e["name"]
                path = f"{d.rstrip('/')}/{e['name']}"
                if e.get("is_directory"):
                    lines.append(f"D {path}")
                    stack.append(path)
                else:
                    chunks = ",".join(
                        f"{ch.get('file_id', '')}@{ch.get('offset', 0)}+{ch.get('size', 0)}"
                        for ch in e.get("chunks", []))
                    lines.append(f"F {path} {chunks}")
            if len(page) < 1000:
                break
    for line in sorted(lines):
        h.update(line.encode() + b"\n")
    return h.hexdigest()
