"""Cross-daemon deadline propagation ("The Tail at Scale": a request that
blew its budget should stop at the first hop that notices).

The port of the JAX package's ``util/deadline.py``:

- ``X-Sweed-Deadline: <absolute epoch seconds>`` rides beside
  ``X-Sweed-Trace`` on every internal HTTP call (the transports of
  ``server/http_util.py`` and ``server/aio_transport.py`` inject both at one
  choke point).
- A ``contextvars.ContextVar`` holds the active deadline, so the same code
  is right in both serving cores (as ``stats/trace.py``).
- Inbound, both dispatchers parse the header; a request whose budget is
  already spent is answered ``504 deadline exceeded`` without running, and
  its span is marked ``cancelled``.
- Outbound, the transports clamp their socket timeout to the remaining
  budget (``clamp_timeout``) and refuse to dial once it is spent
  (``DeadlineExceeded``).

Absolute epoch seconds, not a relative budget, so a request that waits in
a queue loses that time too. ``SWEED_DEADLINE=0`` turns it off. The header
is trusted as far as ``X-Sweed-Trace`` is: a private network.
"""

from __future__ import annotations

import contextvars
import os
import time
from typing import Optional

from .locks import make_lock

DEADLINE_HEADER = "X-Sweed-Deadline"

#: Floor for clamped socket timeouts: 0 would mean "block forever" to
#: most socket APIs, so the clamp never goes below this.
MIN_TIMEOUT = 0.001


class DeadlineExceeded(OSError):
    """Raised by the transports when the ambient deadline is already
    spent before the request would go on the wire. An OSError so callers'
    existing dead-peer handling applies (retry loops stop — retrying a
    doomed request is exactly what deadline propagation exists to kill).
    """

    def __init__(self, overdue: float):
        super().__init__(f"deadline exceeded ({overdue * 1000.0:.0f}ms ago)")
        self.overdue = overdue


def enabled() -> bool:
    """Kill switch; read per call so tests flip it live."""
    return os.environ.get("SWEED_DEADLINE", "1").strip() != "0"


_current: contextvars.ContextVar[Optional[float]] = contextvars.ContextVar(
    "sweed_deadline", default=None
)


def current() -> Optional[float]:
    """The active absolute deadline (epoch seconds), or None."""
    return _current.get()


def remaining() -> Optional[float]:
    """Seconds of budget left (may be <= 0), or None when no deadline."""
    d = _current.get()
    if d is None:
        return None
    return d - time.time()


def expired() -> bool:
    r = remaining()
    return r is not None and r <= 0


def clamp_timeout(timeout: float) -> float:
    """A transport timeout bounded by the remaining budget.

    Raises :class:`DeadlineExceeded` when the budget is already spent —
    the caller must not put the request on the wire. Without an ambient
    deadline the timeout passes through untouched."""
    r = remaining()
    if r is None:
        return timeout
    if r <= 0:
        note("refused_dial")
        raise DeadlineExceeded(-r)
    if timeout > r:
        note("clamped")
    return max(MIN_TIMEOUT, min(timeout, r))


def inject_header() -> Optional[str]:
    """Header value for an outbound internal call, or None when no
    deadline is active (requests without a budget stay clean)."""
    if not enabled():
        return None
    d = _current.get()
    if d is None:
        return None
    return f"{d:.6f}"


def parse_header(value: Optional[str]) -> Optional[float]:
    """X-Sweed-Deadline value → absolute epoch seconds, or None for
    absent/garbage (a malformed header must not 500 the daemon — the
    request simply runs unbudgeted, like one that never carried it)."""
    if not value:
        return None
    raw = value.strip()
    if not raw.isascii():
        return None
    try:
        d = float(raw)
    except ValueError:
        return None
    # NaN fails both comparisons; inf/absurd values are garbage too —
    # accept only plausible epoch timestamps (year ~2001 .. ~33658)
    if not (1e9 < d < 1e12):
        return None
    return d


_counts: dict[str, int] = {}
_counts_lock = make_lock("deadline._counts")


def note(kind: str) -> None:
    """Count a deadline event for /metrics (``sweed_deadline_*``):
    ``expired_inbound`` (request answered 504 without running),
    ``aborted_handler`` (handler stopped mid-flight by a spent budget),
    ``refused_dial`` (transport refused to put a doomed request on the
    wire), ``clamped`` (socket timeout shortened to the budget)."""
    with _counts_lock:
        _counts[kind] = _counts.get(kind, 0) + 1


def counts() -> dict:
    with _counts_lock:
        return dict(_counts)


class scope:
    """Context manager owning one deadline's contextvar window. ``None``
    deadlines nest transparently (the outer value stays visible), so
    dispatchers can enter it unconditionally."""

    __slots__ = ("_deadline", "_token")

    def __init__(self, deadline: Optional[float]):
        self._deadline = deadline
        self._token = None

    def __enter__(self) -> Optional[float]:
        if self._deadline is not None:
            self._token = _current.set(self._deadline)
        return self._deadline

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _current.reset(self._token)


def after(seconds: float) -> float:
    """Absolute deadline ``seconds`` from now (client-side convenience)."""
    return time.time() + seconds
