"""Runtime lock-order sanitizer — the dynamic half of the static lock
graph in ``analysis/lockgraph.py``.

Product code creates its locks through the factories here::

    self._lock = make_rlock("Topology._lock")

With ``SWEED_LOCK_CHECK`` unset (production) the factories return plain
``threading.Lock``/``RLock`` — zero overhead, nothing recorded.  With
``SWEED_LOCK_CHECK=1`` they return :class:`OrderedLock` wrappers that

- keep a per-thread stack of held locks,
- accumulate the observed acquisition-order graph (Eraser-style
  lockset ordering, Savage et al., TOCS 1997),
- raise :class:`LockOrderError` *before blocking* when an acquisition
  would close a cycle in that graph (the ABBA interleaving need not
  actually deadlock to be caught), and
- count acquisitions, contended acquires, and the deepest
  held-while-acquiring nesting, exposed via :func:`lock_stats` and the
  ``/_status`` endpoints.

``SWEED_LOCK_DUMP=<path>`` additionally writes the observed graph as
JSON at interpreter exit, which ``tests/test_lock_order.py`` uses to
assert every dynamically observed edge appears in the statically
computed graph (static ⊇ dynamic cross-check).

The lock NAME is the contract with the static side: pass the same
``"ClassName._attr"`` string the static analysis derives, and the two
graphs become directly comparable.  Same-name edges (two instances of
the same class) are intentionally not recorded — both sides work at
per-class granularity.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import traceback
from typing import Optional


class LockOrderError(RuntimeError):
    """An acquisition would invert the observed lock order (potential
    ABBA deadlock)."""


def enabled() -> bool:
    """Read at every factory call, not import time, so a test harness can
    flip the environment before constructing servers."""
    return os.environ.get("SWEED_LOCK_CHECK", "") == "1"


def _site() -> str:
    """file:line of the product-code acquisition site (skip this module)."""
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.endswith(("locks.py", "threading.py")):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


class _Registry:
    """Process-global observed-order graph + counters."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.edges: dict[tuple[str, str], str] = {}  # (a, b) → first site
        self.acquisitions: dict[str, int] = {}
        self.contended: dict[str, int] = {}
        self.max_depth = 0  # deepest held-while-acquiring nesting seen

    def _reaches(self, src: str, dst: str) -> bool:
        """True when dst is reachable from src in the observed graph."""
        seen = {src}
        stack = [src]
        while stack:
            cur = stack.pop()
            for (a, b) in self.edges:
                if a == cur and b not in seen:
                    if b == dst:
                        return True
                    seen.add(b)
                    stack.append(b)
        return False

    def check_order(self, held: list[str], name: str) -> None:
        """Record held→name edges; raise before the caller blocks if one
        of them would close a cycle."""
        with self._mu:
            for h in held:
                if h == name:
                    continue  # per-class granularity, reentrancy
                if (h, name) in self.edges:
                    continue
                if self._reaches(name, h):
                    first = next(
                        (
                            f"{a}→{b} at {s}"
                            for (a, b), s in self.edges.items()
                            if a == name
                        ),
                        f"{name}→…",
                    )
                    raise LockOrderError(
                        f"lock-order inversion: acquiring {name!r} while "
                        f"holding {h!r}, but the opposite order was "
                        f"observed earlier ({first}); see docs/LOCKS.md "
                        "for the canonical hierarchy"
                    )
                self.edges[(h, name)] = _site()

    def note_acquired(self, name: str, depth: int) -> None:
        with self._mu:
            self.acquisitions[name] = self.acquisitions.get(name, 0) + 1
            if depth > self.max_depth:
                self.max_depth = depth

    def note_contended(self, name: str) -> None:
        with self._mu:
            self.contended[name] = self.contended.get(name, 0) + 1

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "enabled": enabled(),
                "acquisitions": sum(self.acquisitions.values()),
                "contended": sum(self.contended.values()),
                "max_held_depth": self.max_depth,
                "edges": sorted(f"{a} -> {b}" for (a, b) in self.edges),
                "per_lock": {
                    n: {
                        "acquisitions": c,
                        "contended": self.contended.get(n, 0),
                    }
                    for n, c in sorted(self.acquisitions.items())
                },
            }

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.acquisitions.clear()
            self.contended.clear()
            self.max_depth = 0


_registry = _Registry()
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class OrderedLock:
    """Drop-in ``Lock``/``RLock`` that reports its acquisitions to the
    order registry.  Implements the ``Condition`` owner protocol
    (``_release_save``/``_acquire_restore``/``_is_owned``) so
    ``make_condition(ordered_lock)`` waits correctly."""

    __slots__ = ("name", "_kind", "_inner")

    def __init__(self, name: str, kind: str = "lock"):
        self.name = name
        self._kind = kind
        self._inner = threading.RLock() if kind == "rlock" else threading.Lock()

    # -- core ------------------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = _stack()
        reentrant = self._kind == "rlock" and any(e is self for e in s)
        if not reentrant:
            _registry.check_order([e.name for e in s], self.name)
        got = self._inner.acquire(False)
        if not got:
            _registry.note_contended(self.name)
            if not blocking:
                return False
            if timeout == -1:
                got = self._inner.acquire()
            else:
                got = self._inner.acquire(True, timeout)
        if got:
            s.append(self)
            _registry.note_acquired(self.name, len(s))
        return got

    def release(self) -> None:
        s = _stack()
        for i in range(len(s) - 1, -1, -1):
            if s[i] is self:
                del s[i]
                break
        self._inner.release()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self._kind == "rlock":
            # a probing acquire(False) would succeed reentrantly for the
            # owning thread, so check ownership first
            if self._inner._is_owned():
                return True
            if self._inner.acquire(False):
                self._inner.release()
                return False
            return True
        return self._inner.locked()

    # -- Condition owner protocol ---------------------------------------------
    def _release_save(self):
        s = _stack()
        count = sum(1 for e in s if e is self)
        s[:] = [e for e in s if e is not self]
        if self._kind == "rlock":
            return (self._inner._release_save(), count)
        self._inner.release()
        return (None, count)

    def _acquire_restore(self, state) -> None:
        inner_state, count = state
        if self._kind == "rlock":
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        _stack().extend([self] * count)

    def _is_owned(self) -> bool:
        if self._kind == "rlock":
            return self._inner._is_owned()
        return any(e is self for e in _stack())

    def __repr__(self) -> str:
        return f"<OrderedLock {self.name} kind={self._kind}>"


# -- factories (what product code calls) --------------------------------------


def make_lock(name: str):
    """A ``threading.Lock`` — or its order-checked wrapper under
    ``SWEED_LOCK_CHECK=1``.  ``name`` must match the static analyzer's
    node id for this lock: ``"ClassName._attr"``."""
    return OrderedLock(name, "lock") if enabled() else threading.Lock()


def make_rlock(name: str):
    """``threading.RLock`` flavor of :func:`make_lock`."""
    return OrderedLock(name, "rlock") if enabled() else threading.RLock()


def make_condition(lock=None):
    """``threading.Condition`` over a :func:`make_lock`-made lock (or a
    plain one).  The OrderedLock owner protocol keeps wait()'s
    release/re-acquire visible to the order registry."""
    return threading.Condition(lock)


# -- introspection -------------------------------------------------------------


def lock_stats() -> dict:
    """Counters + observed edges for metrics and ``/_status``."""
    return _registry.snapshot()


def observed_edges() -> list[tuple[str, str]]:
    with _registry._mu:
        return sorted(_registry.edges)


def reset_observed() -> None:
    """Test hook: forget the observed graph and counters."""
    _registry.reset()


def _dump_at_exit() -> None:
    path = os.environ.get("SWEED_LOCK_DUMP", "")
    if not path or not enabled():
        return
    snap = _registry.snapshot()
    snap["edge_sites"] = {
        f"{a} -> {b}": s for (a, b), s in _registry.edges.items()
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(snap, f, indent=1)
    os.replace(tmp, path)


atexit.register(_dump_at_exit)


__all__ = [
    "LockOrderError",
    "OrderedLock",
    "enabled",
    "lock_stats",
    "make_condition",
    "make_lock",
    "make_rlock",
    "observed_edges",
    "reset_observed",
]
