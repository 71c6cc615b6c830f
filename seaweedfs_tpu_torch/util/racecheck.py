"""Runtime cross-domain race sanitizer — the dynamic half of
``analysis/racecheck.py``.

With ``SWEED_RACE_CHECK`` unset (production) :func:`instrument` is an
identity function: the class's ``__setattr__`` is untouched and the
steady-state cost is zero.  With ``SWEED_RACE_CHECK=1`` the named shared
structures (each marked ``@instrument`` at its definition) get a
``__setattr__`` wrapper running the Eraser lockset state machine
(Savage et al., TOCS 1997) at execution-domain granularity:

- every attribute write notes the current domain — ``loop`` (a running
  asyncio loop on this thread), ``handler`` (an ``aio-worker`` pool
  thread), or ``background`` (any other thread) — and the set of
  ``make_lock``-named locks the thread holds (``util/locks.py``; the
  lockset is only populated under ``SWEED_LOCK_CHECK=1``, so run both
  knobs together),
- writes made while the object's ``__init__`` is running are not
  tracked — the object is not shared while it is being built (the
  static rule's ``_CTOR_NAMES`` exemption, Eraser's initialization
  state),
- a location starts *exclusive* to its first post-construction
  writer's domain (covers single-domain objects),
- the first write from a second domain moves it to *shared* and seeds
  the candidate lockset C with the locks held right then; every later
  write refines ``C &= held``,
- when a shared location's C goes empty the write is recorded as an
  observation — never raised, the sanitizer observes — keyed
  ``ClassName.attr``, the exact name the static candidate set uses
  (:func:`analysis.racecheck.compute_race_report`), so
  ``tests/test_racecheck.py`` can assert observed ⊆ static.

``SWEED_RACE_DUMP=<path>`` writes the observations as JSON at
interpreter exit (the ``SWEED_LOCK_DUMP`` precedent).

Instrumentation is per-instance-id without keeping instances alive, so
an id can be recycled after gc; ``__init__`` entry forgets any state
recorded under the id, so a newborn object never inherits a dead
object's write history.  The table is bounded (``MAX_TRACKED``
locations); at the cap it is cleared, restarting every live location
in the exclusive state.
"""

from __future__ import annotations

import asyncio
import atexit
import json
import os
import threading

from .locks import _stack

LOOP = "loop"
HANDLER = "handler"
BACKGROUND = "background"

#: thread-name prefix the aio serving core gives its worker pool
#: (server/aio.py thread_name_prefix) — the runtime marker of the
#: static "handler" domain
HANDLER_THREAD_PREFIX = "aio-worker"


def enabled() -> bool:
    """Read per :func:`instrument` call (class definition time), so the
    environment must be set before the product modules are imported."""
    return os.environ.get("SWEED_RACE_CHECK", "") == "1"


def current_domain() -> str:
    """The execution domain of the calling code, mirroring the static
    classification in ``analysis/domaingraph.py``."""
    try:
        asyncio.get_running_loop()
        return LOOP
    except RuntimeError:
        pass
    if threading.current_thread().name.startswith(HANDLER_THREAD_PREFIX):
        return HANDLER
    return BACKGROUND


class _Tracker:
    """Process-global write-history table + observation sink."""

    MAX_TRACKED = 1 << 16

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # id(obj) → {attr → [set of domains, candidate lockset C or None]}
        self._state: dict[int, dict[str, list]] = {}
        self._tracked = 0  # total locations across all ids
        # id(obj) → __init__ nesting depth (writes suspended while > 0)
        self._in_init: dict[int, int] = {}
        # "ClassName.attr" → {"domains": set, "count": int}
        self._observed: dict[str, dict] = {}

    def begin_init(self, obj) -> None:
        """Constructor entry: the id may be recycled from a dead object
        — forget its history — and writes until :meth:`end_init` belong
        to the unshared initialization state."""
        oid = id(obj)
        with self._mu:
            dropped = self._state.pop(oid, None)
            if dropped:
                self._tracked -= len(dropped)
            self._in_init[oid] = self._in_init.get(oid, 0) + 1

    def end_init(self, obj) -> None:
        oid = id(obj)
        with self._mu:
            depth = self._in_init.get(oid, 0) - 1
            if depth <= 0:
                self._in_init.pop(oid, None)
            else:
                self._in_init[oid] = depth

    def note_write(self, obj, attr: str) -> None:
        domain = current_domain()
        held = frozenset(e.name for e in _stack())
        oid = id(obj)
        with self._mu:
            if oid in self._in_init:
                return
            attrs = self._state.get(oid)
            if attrs is None:
                if self._tracked >= self.MAX_TRACKED:
                    self._state.clear()
                    self._tracked = 0
                attrs = self._state[oid] = {}
            st = attrs.get(attr)
            if st is None:
                attrs[attr] = [{domain}, None]
                self._tracked += 1
                return
            domains, cand = st
            if domain not in domains:
                domains.add(domain)
                # ownership transfer: C seeds from the locks held at the
                # first second-domain write, not the exclusive history
                cand = held if cand is None else (cand & held)
            elif cand is not None:
                cand = cand & held
            st[1] = cand
            if len(domains) >= 2 and cand is not None and not cand:
                name = f"{type(obj).__name__}.{attr}"
                o = self._observed.get(name)
                if o is None:
                    o = self._observed[name] = {"domains": set(), "count": 0}
                o["domains"].update(domains)
                o["count"] += 1

    def observations(self) -> list[dict]:
        with self._mu:
            return [
                {
                    "name": name,
                    "domains": sorted(o["domains"]),
                    "count": o["count"],
                }
                for name, o in sorted(self._observed.items())
            ]

    def reset(self) -> None:
        # _in_init is left alone: a constructor running on another
        # thread must not have its suspension pulled out from under it
        with self._mu:
            self._state.clear()
            self._tracked = 0
            self._observed.clear()


_tracker = _Tracker()


def instrument(cls):
    """Class decorator: wrap ``__setattr__`` with the write recorder
    when ``SWEED_RACE_CHECK=1``; the identity function otherwise, so a
    production class carries no wrapper and no extra dict entry."""
    if not enabled():
        return cls
    if "__sweed_race_wrapped__" in cls.__dict__:
        return cls
    orig = cls.__setattr__
    orig_init = cls.__init__

    def __setattr__(self, name, value, _orig=orig):
        _tracker.note_write(self, name)
        _orig(self, name, value)

    def __init__(self, *args, _orig=orig_init, **kwargs):
        _tracker.begin_init(self)
        try:
            _orig(self, *args, **kwargs)
        finally:
            _tracker.end_init(self)

    cls.__setattr__ = __setattr__
    cls.__init__ = __init__
    cls.__sweed_race_wrapped__ = True
    return cls


def observations() -> list[dict]:
    """Every shared location observed written from ≥ 2 domains with an
    empty candidate lockset, as ``{"name", "domains", "count"}`` dicts."""
    return _tracker.observations()


def reset_observed() -> None:
    """Test hook: forget all write history and observations."""
    _tracker.reset()


def _dump_at_exit() -> None:
    path = os.environ.get("SWEED_RACE_DUMP", "")
    if not path or not enabled():
        return
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"observations": observations()}, f, indent=1)
    os.replace(tmp, path)


atexit.register(_dump_at_exit)


__all__ = [
    "BACKGROUND",
    "HANDLER",
    "LOOP",
    "current_domain",
    "enabled",
    "instrument",
    "observations",
    "reset_observed",
]
