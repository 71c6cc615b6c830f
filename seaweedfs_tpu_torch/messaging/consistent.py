"""Consistent-hash ring for partition→member placement: the port's copy of
the JAX package's ``messaging/consistent.py`` (after the reference's
`messaging/broker/consistent_distribution.go`, which wraps
stathat/consistent: 20 virtual replicas per member, lookup by key).

The sharded filer fleet (``filer/ring.py``) maps directory-tree shard keys
onto filers with it, so its placement is a contract between packages: for
the same member set, a port filer and a JAX filer name the same owner, or a
mixed fleet splits its tree. The hash (the first 8 bytes of MD5, big-endian)
and the virtual-node names (``member#i``) are the JAX package's.

- empty ring: ``get`` raises LookupError (callers own the "no members"
  story); single member: every key maps to it.
- determinism: the ring's layout is a pure function of its member SET —
  add/remove order never changes placement, and re-adding a removed
  member restores the exact previous layout.
- duplicate virtual-node collisions: two members' virtual nodes may hash
  identically; ties break on the member name, so both survive, lookups
  stay deterministic, and removing one member never disturbs the other's
  nodes.
"""

from __future__ import annotations

import bisect
import hashlib


def _hash(key: "str | bytes") -> int:
    if isinstance(key, str):
        key = key.encode()
    return int.from_bytes(hashlib.md5(key).digest()[:8], "big")


class ConsistentRing:
    def __init__(self, replicas: int = 20):
        self.replicas = max(1, replicas)
        # sorted parallel arrays: _keys holds virtual-node hashes, _owners
        # the member each belongs to. Entries sort by (hash, member) so a
        # cross-member hash collision keeps BOTH nodes in a stable order
        # instead of one silently shadowing the other.
        self._keys: list[int] = []
        self._owners: list[str] = []
        self._members: set[str] = set()

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        self._rebuild()

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        self._rebuild()

    def _rebuild(self) -> None:
        # rebuilt from the member SET every time: layout is independent of
        # the add/remove sequence by construction
        ring = sorted(
            (_hash(f"{member}#{i}"), member)
            for member in self._members
            for i in range(self.replicas)
        )
        self._keys = [h for h, _ in ring]
        self._owners = [m for _, m in ring]

    def members(self) -> list[str]:
        return sorted(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, member: str) -> bool:
        return member in self._members

    def get(self, key: str) -> str:
        """The member owning ``key``: first virtual node clockwise of the
        key's hash. Raises LookupError on an empty ring."""
        if not self._members:
            raise LookupError("empty ring")
        if len(self._members) == 1:
            return next(iter(self._members))
        # bisect_right: a key hashing EXACTLY onto a virtual node walks
        # past all colliding nodes at that hash — deterministic regardless
        # of how many members collide there
        idx = bisect.bisect_right(self._keys, _hash(key)) % len(self._keys)
        return self._owners[idx]
