"""Hedged requests (Dean & Barroso, "The Tail at Scale").

A read whose primary replica is momentarily slow — GC pause, queued
spindle, dying disk — pays that replica's tail latency even though a
healthy copy sits one hop away. The classic fix: after a delay derived
from the live p99 (so only the slowest ~1% of requests hedge), fire the
SAME request at a second replica and take whichever answers first.

Two variants, one per serving core:

- :func:`hedged_call` — thread legs for the bridged read path. A losing
  leg cannot be truly cancelled (a blocking socket read has no cancel
  handle), so it is abandoned: its thread finishes the response and
  repools its own socket; the abandonment is counted as a cancel.
- :func:`ahedged_call` — asyncio tasks for the native read path; the
  loser gets a real ``task.cancel()``.

The hedge budget bounds extra backend load: hedges may fire on at most
``SWEED_HEDGE_BUDGET`` (default 5%) of tracked calls, so a systemic
slowdown — where hedging every request would double cluster load exactly
when it can least afford it — degrades to ordinary serial failover.
Counters live here (process-wide) and the filer's ``/_status`` reports
them under ``hedge``.

The port's copy of the JAX package's ``util/hedge.py``, with one
difference: ``hedged_call``'s thread legs run in a copy of the caller's
context, so a chunk fetched from an EC'd volume (whose lookup names several
holders) stays in the request's trace and under its deadline; the JAX
package's legs start with an empty context.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
from typing import Callable, Optional


def enabled() -> bool:
    """Hedging kill switch; read per call so tests flip it live."""
    return os.environ.get("SWEED_HEDGE", "1").strip() != "0"


def budget_ratio() -> float:
    """Max fraction of tracked calls that may fire a hedge leg."""
    raw = os.environ.get("SWEED_HEDGE_BUDGET", "0.05").strip()
    try:
        v = float(raw)
    except ValueError:
        return 0.05
    return min(1.0, max(0.0, v)) if v == v else 0.05  # NaN → default


def delay_override_s() -> Optional[float]:
    """Fixed hedge delay from the env (ms), or None to use the live p99.
    Tests pin this so the trigger point is deterministic."""
    raw = os.environ.get("SWEED_HEDGE_DELAY_MS", "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return max(0.0, v) / 1000.0 if v == v else None


class HedgeStats:
    """Process-wide hedge counters + the budget gate."""

    def __init__(self):
        self._lock = threading.Lock()
        self.tracked = 0        # calls that passed through the hedger
        self.fired = 0          # hedge legs actually launched
        self.wins = {"primary": 0, "hedge": 0}
        self.cancelled = 0      # losing legs cancelled/abandoned
        self.skipped_budget = 0  # hedges suppressed by the budget gate

    def note_tracked(self) -> None:
        with self._lock:
            self.tracked += 1

    def try_fire(self) -> bool:
        """Budget gate + fire accounting in one atomic step: True means
        the caller may launch a hedge leg. The gate compares hedges
        against the budgeted fraction of tracked calls, with a small
        grace floor so the very first slow requests can still hedge
        before enough history accumulates."""
        ratio = budget_ratio()
        with self._lock:
            allowance = max(4.0, self.tracked * ratio)
            if ratio <= 0 or self.fired + 1 > allowance:
                self.skipped_budget += 1
                return False
            self.fired += 1
            return True

    def note_win(self, leg: str, loser_inflight: bool) -> None:
        with self._lock:
            self.wins[leg] = self.wins.get(leg, 0) + 1
            if loser_inflight:
                self.cancelled += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tracked": self.tracked,
                "fired": self.fired,
                "wins_primary": self.wins.get("primary", 0),
                "wins_hedge": self.wins.get("hedge", 0),
                "cancelled": self.cancelled,
                "skipped_budget": self.skipped_budget,
            }

    def reset(self) -> None:  # tests
        with self._lock:
            self.tracked = 0
            self.fired = 0
            self.wins = {"primary": 0, "hedge": 0}
            self.cancelled = 0
            self.skipped_budget = 0


STATS = HedgeStats()


def pick_delay_s(p99_s: Optional[float], floor_s: float = 0.002,
                 default_s: float = 0.05) -> float:
    """The hedge trigger delay: env override > live p99 (clamped to a
    floor so microsecond-fast caches don't hedge everything) > default
    when no latency evidence exists yet."""
    override = delay_override_s()
    if override is not None:
        return override
    if p99_s is None or p99_s <= 0:
        return default_s
    return max(floor_s, p99_s)


_UNSET = object()


def hedged_call(primary: Callable[[], object],
                hedge: Optional[Callable[[], object]],
                delay_s: float):
    """Run ``primary``; if it hasn't answered after ``delay_s`` (and the
    budget allows), launch ``hedge`` and return the first success.

    Returns ``(result, winner)`` where winner is "primary" or "hedge".
    When both legs fail, the primary's error is raised (the hedge's is
    secondary evidence, not the story). With no hedge leg available or
    hedging disabled, this degrades to a plain ``primary()`` call on the
    calling thread — zero threads spent."""
    if hedge is None or not enabled():
        return primary(), "primary"
    STATS.note_tracked()
    results: "queue.Queue" = queue.Queue()

    # each leg runs in a copy of the caller's context, so its requests
    # carry the caller's span and deadline (threads start with an empty one)
    ctx = contextvars.copy_context()

    def run(leg: str, fn: Callable[[], object]) -> None:
        try:
            results.put((leg, True, ctx.copy().run(fn)))
        except Exception as e:  # leg outcome is relayed; the decider re-raises
            results.put((leg, False, e))

    t1 = threading.Thread(target=run, args=("primary", primary), daemon=True)
    t1.start()
    launched = 1
    try:
        leg, ok, val = results.get(timeout=delay_s)
    except queue.Empty:
        leg = None
    if leg is None or not ok:
        # slow OR failed primary: both are the moment to try the replica
        # (a failed primary is plain failover and bypasses the budget)
        if leg is None:
            if STATS.try_fire():
                threading.Thread(
                    target=run, args=("hedge", hedge), daemon=True
                ).start()
                launched = 2
        else:
            threading.Thread(
                target=run, args=("hedge", hedge), daemon=True
            ).start()
            launched = 2
        errors = [] if leg is None else [val]
        settled = len(errors)
        while True:
            leg, ok, val = results.get()
            settled += 1
            if ok:
                break
            errors.append(val)
            if settled >= launched:
                raise errors[0]
    STATS.note_win(leg, loser_inflight=(launched == 2 and leg is not None))
    return val, leg


async def ahedged_call(primary_fn, hedge_fn, delay_s: float):
    """Asyncio mirror of :func:`hedged_call`: ``primary_fn``/``hedge_fn``
    are zero-arg coroutine factories. The losing task is truly cancelled.
    Returns ``(result, winner)``; both-failed raises the primary's error.
    """
    import asyncio

    if hedge_fn is None or not enabled():
        return await primary_fn(), "primary"
    STATS.note_tracked()
    p = asyncio.ensure_future(primary_fn())
    done, _ = await asyncio.wait({p}, timeout=delay_s)
    if p in done and p.exception() is None:
        return p.result(), "primary"
    h = None
    if p in done:
        # primary already failed: failover, not a budgeted hedge
        h = asyncio.ensure_future(hedge_fn())
    elif STATS.try_fire():
        h = asyncio.ensure_future(hedge_fn())
    if h is None:
        res = await p
        STATS.note_win("primary", loser_inflight=False)
        return res, "primary"
    tasks = {t for t in (p, h) if not t.done() or t.exception() is None}
    errors = [p.exception()] if (p.done() and p.exception()) else []
    try:
        while tasks:
            done, tasks = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_COMPLETED
            )
            for t in done:
                if t.cancelled():
                    continue
                if t.exception() is None:
                    winner = "primary" if t is p else "hedge"
                    for loser in tasks:
                        loser.cancel()
                    STATS.note_win(winner, loser_inflight=bool(tasks))
                    return t.result(), winner
                errors.append(t.exception())
        raise errors[0]
    except asyncio.CancelledError:
        for t in (p, h):
            if t is not None:
                t.cancel()
        raise
