"""Lock factories: the plain form of the JAX package's ``util/locks.py``.

Product code makes its locks through ``make_lock(name)`` /
``make_rlock(name)`` / ``make_condition(lock)``, so that the lock-order
sanitizer can be slotted in under ``SWEED_LOCK_CHECK=1`` without touching a
call site. The sanitizer (``OrderedLock``, its order registry and the
at-exit dump) is not ported yet: every factory returns the ``threading``
primitive, and ``lock_stats()`` reports the sanitizer off with empty
counters, in the JAX package's format.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    """A ``threading.Lock``. ``name`` is the lock's id in the sanitizer's
    graph (``"ClassName._attr"``), kept so call sites match the JAX
    package's."""
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` (see :func:`make_lock`)."""
    return threading.RLock()


def make_condition(lock=None):
    """A ``threading.Condition`` over ``lock`` (a new lock when None)."""
    return threading.Condition(lock)


def lock_stats() -> dict:
    """The sanitizer's counters for metrics and ``/_status``: off, empty."""
    return {"enabled": False, "acquisitions": 0, "contended": 0,
            "max_held_depth": 0, "edges": [], "per_lock": {}}


def observed_edges() -> list[tuple[str, str]]:
    """Lock-order edges the sanitizer observed: none while it is off."""
    return []


def reset_observed() -> None:
    """Test hook: forget the observed graph (nothing to forget)."""


__all__ = ["lock_stats", "make_condition", "make_lock",
           "make_rlock", "observed_edges", "reset_observed"]
